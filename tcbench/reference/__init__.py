"""Plain float32 PyTorch reference of the sampling stage.

It imports nothing of the program under test: the UNet of IC-Light fc on
SD1.5 with VidToMe token merging (`unet.py`, `tome.py`), the chunk plans
(`chunks.py`), the multistep DPM-Solver++ (SDE) step (`dpm.py`), the yt
pass and its fusion (`step.py`), and the seeded weights both sides are
handed (`weights.py`). Matrix products run in float32 with TF32 off.
"""
