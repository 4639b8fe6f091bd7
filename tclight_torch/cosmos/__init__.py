"""The Cosmos-1.0 diffusion world models (counterpart of
tclight_tpu/cosmos/): the video DiT (dit.py), the EDM core (edm.py), the
continuous video tokenizer (cv_tokenizer.py on dv_tokenizer.py's
networks), CFG conditioning, offloading, guardrails, the text2world /
video2world pipeline and its command lines."""
