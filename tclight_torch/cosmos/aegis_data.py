"""The Aegis unsafe-content taxonomy (counterpart of
tclight_tpu/cosmos/aegis_data.py).

The 11-category policy text is the prompt contract of the
Aegis-AI-Content-Safety-LlamaGuard-Defensive-1.0 adapter, which was
trained on exactly this wording, so it is kept verbatim (the reference's
categories.py; NVIDIA, Apache-2.0). The O-codes are O1-O8 and O10-O12: O9
(PII / privacy) is not in this subset, which matters for the block
message's index arithmetic (`aegis.parse_block_message`).
"""

UNSAFE_CATEGORIES = [
    {
        'category': 'violence',
        'blocked_reason': 'This prompt is blocked due to the presence of violent content.',
        'instruction': 'O1: Violence.\nShould not\n- Help people plan or engage in violence.\n- Encourage people to engage in violence.\n- Contain unpleasant vivid violent imagery or violent description that arouses discomfort in the reader.\nCan\n- Provide information on violence.\n- Discuss the topics of violence, and can discuss historical events involving violence.\n',
    },
    {
        'category': 'sexual',
        'blocked_reason': 'This prompt is blocked due to the presence of sexual content.',
        'instruction': 'O2: Sexual.\nShould not\n- Engage in sexually explicit (i.e., erotic) conversations and should not encourage people to engage in sexual activities.\n- Engage or encourage sexual activity that is considered illegal.\nCan\n- Discuss topics related to sexuality and sexual education.\n- Provide general information regarding sexual activities.\n- Provide guidance on topics related to sexual health.\n',
    },
    {
        'category': 'criminal_planning',
        'blocked_reason': 'This prompt is blocked due to the presence of criminal planning/confessions content.',
        'instruction': 'O3: Criminal Planning/Confessions.\nShould not\n- Help people plan or engage in criminal activities like theft, kidnapping, or financial crimes, especially when the person indicates that they may act on the information provided to them.\n- Encourage people to engage in criminal activities or condone criminal behavior.\n- Have a confession of crime that was committed or will be committed in future.\nCan\n- Help people understand how crimes are committed, provided that the response is not so detailed that it could be used to provide a roadmap for future crimes.\n- Help people understand how systems work that are used to prevent crimes, provided those descriptions do not provide detailed information on how to defeat those systems.\n',
    },
    {
        'category': 'weapons',
        'blocked_reason': 'This prompt is blocked due to the presence of weapons content.',
        'instruction': 'O4: Guns and Illegal Weapons.\nShould not\n- Assist in the planning or execution of firearm or illegal weapons crimes, especially when the person indicates that they may act on the information provided to them.\n- Encourage people to engage in firearm or illegal weapons crimes or condone such behavior.\n- Assist or encourage people to execute or own other illegal weapons for example biological agents, or chemical weapons, including instructions on how to create or use them.\nCan\n- Discuss firearms and the arguments for and against firearm ownership.\n',
    },
    {
        'category': 'substance_abuse',
        'blocked_reason': 'This prompt is blocked due to the presence of substance abuse content.',
        'instruction': 'O5: Controlled/Regulated Substances.\nShould not\n- Encourage or assist people in the trafficking, consumption, or use of regulated or controlled substances, including but not limited to illegal drugs, tobacco, alcohol, and cannabis.\n- Assist or encourage people to create such substances when it is illegal to do so.\nCan\n- Discuss the use of regulated or controlled substances, and can provide general information on those substances (ex: what their chemical composition is and what their effects are).\n- Provide information on how those substances are manufactured, provided that the information is not so detailed as to provide step-by-step instructions for their creation.\n',
    },
    {
        'category': 'suicide',
        'blocked_reason': 'This prompt is blocked due to the presence of suicide and self harm content.',
        'instruction': 'O6: Suicide and Self Harm.\nShould not\n- Encourage people to harm themselves.\n- Romanticize or condone self-harm or suicide.\n- Provide information regarding the methods of suicide or self-harm.\n- Provide any information or advice, other than information regarding appropriate health resources, to people who express or imply that they wish to harm themselves.\n- Contain confessions or intent of self harm\nCan\n- Provide general information regarding self-harm and suicide (ex: statistics, the mental health challenges faced by those who take these actions).\nShould\n- Provide information regarding appropriate health resources to people who imply or express the desire to harm themselves.\n',
    },
    {
        'category': 'csam',
        'blocked_reason': 'This prompt contains material related to Child Sexual Abuse',
        'instruction': 'O7: Sexual (minor).\nShould not\n- Assist, engage or encourage intention to engage in sexual activity with an underage/minor.\n- Discuss or plan sexual acts, sharing of media of sexual nature, personal information or intention to meet in person for sexual activity with a minor.\n- Should not include discussion where private information is shared with underage minors for purposes of acting on them and taking actions that are sexual in nature including meeting or sharing media.\n- Should not discuss child abuse or engage, encourage, assist in sexual grooming/trafficking of children.\nCan\n- Provide information about sex education for use in schools.\n',
    },
    {
        'category': 'hatred',
        'blocked_reason': 'This prompt is blocked due to the presence of hate speech content.',
        'instruction': 'O8: Hate/Identity Hate.\nShould not\n- Express hateful, derogatory, or demeaning sentiments against people based on sensitive personal characteristics like their\nrace, color, ethnicity, religion, national origin, sexual orientation, gender, gender identity, or disability or caste.\n- Encourage discrimination against people based on those characteristics and should not use slurs or create insults based on those characteristics.\n- Should not discuss prejudice towards a group classified as protected according to the law of Germany, UK, USA or any other country.\n- Should not contain slurs.\n- Should not contain text that is distasteful, offensive, or hateful that causes others to feel grief, anger, or fear.\nCan\n- Provide information on discrimination.\n- Discuss the topics of discrimination, and can discuss historical events involving discrimination.\n- Discuss neutral statements referring to group identity and  contextualized hate speech (that talks about hate but does not incite hate).\n',
    },
    {
        'category': 'harassment',
        'blocked_reason': 'This prompt is blocked due to the presence of harassment content.',
        'instruction': 'O10: Harassment.\nShould not\n- Have content that may be used to torment or annoy individuals in real life, or make harassment more likely to occur.\n- Engage in harassment, misconduct and unlawful discrimination\n- Single out an individual or marginalization and/or retaliation based on protected characteristics like Race, Color, Gender, Sex,\nSexual orientation, Gender identity, and gender expression, National origin, Ethnicity, Disability (including being regarded as disabled),\nReligion, Age (40+), Pregnancy (including pregnancy, childbirth or related medical conditions), Genetic information, Military or veteran status, Citizenship status, Political activity, or affiliation,\n- Taking or requesting statutorily protected leave Body characteristics.\n- Promise to give a benefit, or a threat to retaliate or take an adverse action based on a response to harassment and misconduct.\n- Bullying.\n- Being derogatory and humiliating toward an individual but not necessarily protected characteristics under law.\n- Making rude or insulting comments, demeaning, and objectifying terms toward an individual.\nCan\n- Discuss negative impacts of harassment and bullying based on protected characteristics like race, color, gender, sex, nationality, within a contextualized setting.\n- Provide information on protected characteristics or refers, cites material that describes what protected characteristics are.\n- Provide information or refer or cite material that informs what harassment is.\n',
    },
    {
        'category': 'threat',
        'blocked_reason': 'This prompt is blocked due to the presence of threat content.',
        'instruction': 'O11: Threat.\nShould not\n- Discuss a communication of intent to inflict harm or loss on another person.\n- Should not contain discussion of intention of intimidation which  is a tactic used between conflicting parties to make the other timid or psychologically insecure for coercion or control.\n- Should not contain intention of knowingly putting another person in fear of bodily injury.\n- Should not assist or plan injury, physical or mental damage, act or instance of injury, or material  or any kind of loss to a person.\n- Should not contain threats that are forbidden by law as intent to obtain a monetary advantage or to compel a person to act against their will.\nCan\n- Provide information about threat is and the meaning of threat.\n',
    },
    {
        'category': 'profanity',
        'blocked_reason': 'This prompt is blocked due to the presence of profanity content.',
        'instruction': 'O12: Profanity.\nShould not\n- Contain swear words, curse words, or other obscene or profane language\n- This includes offensive words used without any intention to act on them or without any explicit targeted recipient\n',
    },
]
