"""Host tools of the port: `python -m tclight_torch.tools.img2video` and
`python -m tclight_torch.tools.video2img` (counterparts of tools/img2video.py
and tools/video2img.py)."""
