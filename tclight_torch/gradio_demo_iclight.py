"""IC-Light single-image relighting demo of the PyTorch port (fc: text and
light-direction conditioned; counterpart of the root gradio_demo_iclight.py,
with its arguments): RMBG foreground preprocessing, light-direction initial
latents, the quick prompt and subject lists and the advanced options.
`--serve` launches the gradio UI (gradio is imported only then); otherwise
it relights one image and writes it.

Usage (headless, on the card; `--device cpu` for the CPU):
    python -m tclight_torch.gradio_demo_iclight --input fg.png \
        --prompt "warm sunlight" --bg_source "Left Light" --output out.png

Weights: IC-Light fc from ICLIGHT_MODEL_DIR (layout in
tclight_torch/pipeline/iclight.py), else the tiny random stack; the UI's
foreground extraction uses BriaRMBG from the reference checkpoint
RMBG_CKPT when it is set.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

quick_prompts = [
    "sunshine from window",
    "neon light, city",
    "sunset over sea",
    "golden time",
    "sci-fi RGB glowing, cyberpunk",
    "natural lighting",
    "warm atmosphere, at home, bedroom",
    "magic lit",
    "evil, gothic, Yharnam",
    "light and shadow",
    "shadow from window",
    "soft studio lighting",
    "home atmosphere, cozy bedroom illumination",
    "neon, Wong Kar-wai, warm",
]

quick_subjects = [
    "beautiful woman, detailed face",
    "handsome man, detailed face",
]


def build_relighter(device: str = "cuda", mode: str = "fc"):
    """The relighter on IC-Light `mode` from ICLIGHT_MODEL_DIR, or the tiny
    random stack (bf16 on the card, whose kernels take bf16)."""
    import os
    from pathlib import Path

    import torch

    from tclight_torch.pipeline.iclight import build_tiny_iclight, load_iclight
    from tclight_torch.pipeline.single_image import SingleImageRelighter
    from tclight_torch.utils.device import resolve_device

    dev = resolve_device(device)
    model_dir = os.environ.get("ICLIGHT_MODEL_DIR")
    if model_dir and Path(model_dir).exists():
        models = load_iclight(model_dir, mode=mode, device=dev)
    else:
        print("[WARN] ICLIGHT_MODEL_DIR unset; tiny random-weight models")
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        models = build_tiny_iclight(in_channels={"fc": 8, "fbc": 12}[mode], dtype=dtype,
                                    device=dev)
    return SingleImageRelighter(models)


def build_rmbg(device: str = "cuda"):
    """BriaRMBG from the reference checkpoint RMBG_CKPT; None when unset."""
    import os
    from pathlib import Path

    from tclight_torch.models.briarmbg import load_rmbg
    from tclight_torch.utils.device import resolve_device

    path = os.environ.get("RMBG_CKPT")
    if not (path and Path(path).exists()):
        return None
    return load_rmbg(path, resolve_device(device))


def make_process_relight(relight, rmbg):
    """process_relight with the reference's signature: RMBG grey-composite
    preprocessing, then the two-pass fc pipeline; returns the preprocessed
    foreground plus a gallery of results (reference :335-345)."""
    import numpy as np

    from tclight_torch.pipeline.single_image import BGSource, run_rmbg_composite

    def process_relight(input_fg, prompt, image_width, image_height,
                        num_samples, seed, steps, a_prompt, n_prompt, cfg,
                        highres_scale, highres_denoise, lowres_denoise,
                        bg_source):
        fg = input_fg.astype(np.float32) / 255.0
        if rmbg is not None:
            fg, _ = run_rmbg_composite(rmbg, fg)
        r = dataclasses.replace(
            relight, steps=int(steps), guidance_scale=float(cfg),
            added_prompt=a_prompt, negative_prompt=n_prompt)
        outs = []
        for i in range(int(num_samples)):
            out = r.process(
                fg, prompt, BGSource(bg_source), int(seed) + i,
                highres_scale=float(highres_scale),
                highres_denoise=float(highres_denoise),
                lowres_denoise=float(lowres_denoise),
                image_width=int(image_width), image_height=int(image_height),
            )
            outs.append((out * 255).astype(np.uint8))
        return (fg * 255).astype(np.uint8), outs

    return process_relight


def serve(device: str = "cuda") -> int:
    try:
        import gradio as gr
    except ImportError:
        print("gradio is not installed; run headless with --input")
        return 1

    import db_examples
    from tclight_torch.pipeline.single_image import BGSource

    relight = build_relighter(device)
    process_relight = make_process_relight(relight, build_rmbg(device))

    block = gr.Blocks().queue()
    with block:
        with gr.Row():
            gr.Markdown("## IC-Light (Relighting with Foreground Condition)")
        with gr.Row():
            with gr.Column():
                with gr.Row():
                    input_fg = gr.Image(type="numpy", label="Image", height=480)
                    output_bg = gr.Image(type="numpy",
                                         label="Preprocessed Foreground",
                                         height=480)
                prompt = gr.Textbox(label="Prompt")
                bg_source = gr.Radio(
                    choices=[e.value for e in BGSource],
                    value=BGSource.NONE.value,
                    label="Lighting Preference (Initial Latent)", type="value")
                example_quick_subjects = gr.Dataset(
                    samples=[[x] for x in quick_subjects],
                    label="Subject Quick List", samples_per_page=1000,
                    components=[prompt])
                example_quick_prompts = gr.Dataset(
                    samples=[[x] for x in quick_prompts],
                    label="Lighting Quick List", samples_per_page=1000,
                    components=[prompt])
                relight_button = gr.Button(value="Relight")

                with gr.Group():
                    with gr.Row():
                        num_samples = gr.Slider(label="Images", minimum=1,
                                                maximum=12, value=1, step=1)
                        seed = gr.Number(label="Seed", value=12345, precision=0)
                    with gr.Row():
                        image_width = gr.Slider(label="Image Width", minimum=256,
                                                maximum=1024, value=512, step=64)
                        image_height = gr.Slider(label="Image Height",
                                                 minimum=256, maximum=1024,
                                                 value=640, step=64)
                with gr.Accordion("Advanced options", open=False):
                    steps = gr.Slider(label="Steps", minimum=1, maximum=100,
                                      value=25, step=1)
                    cfg = gr.Slider(label="CFG Scale", minimum=1.0,
                                    maximum=32.0, value=2, step=0.01)
                    lowres_denoise = gr.Slider(
                        label="Lowres Denoise (for initial latent)",
                        minimum=0.1, maximum=1.0, value=0.9, step=0.01)
                    highres_scale = gr.Slider(label="Highres Scale",
                                              minimum=1.0, maximum=3.0,
                                              value=1.5, step=0.01)
                    highres_denoise = gr.Slider(label="Highres Denoise",
                                                minimum=0.1, maximum=1.0,
                                                value=0.5, step=0.01)
                    a_prompt = gr.Textbox(label="Added Prompt",
                                          value="best quality")
                    n_prompt = gr.Textbox(
                        label="Negative Prompt",
                        value="lowres, bad anatomy, bad hands, "
                              "cropped, worst quality")
            with gr.Column():
                result_gallery = gr.Gallery(height=832, object_fit="contain",
                                            label="Outputs")
        rows = db_examples.available(
            db_examples.foreground_conditioned_examples, img_cols=(0,))
        if rows:
            dummy_image_for_outputs = gr.Image(visible=False, label="Result")
            gr.Examples(
                fn=lambda *a: ([a[-1]], None),
                examples=rows,
                inputs=[input_fg, prompt, bg_source, image_width,
                        image_height, seed, dummy_image_for_outputs],
                outputs=[result_gallery, output_bg],
                run_on_click=True, examples_per_page=1024,
            )
        ips = [input_fg, prompt, image_width, image_height, num_samples, seed,
               steps, a_prompt, n_prompt, cfg, highres_scale, highres_denoise,
               lowres_denoise, bg_source]
        relight_button.click(fn=process_relight, inputs=ips,
                             outputs=[output_bg, result_gallery])
        example_quick_prompts.click(
            lambda x, y: ", ".join(y.split(", ")[:2] + [x[0]]),
            inputs=[example_quick_prompts, prompt], outputs=prompt,
            show_progress=False, queue=False)
        example_quick_subjects.click(
            lambda x: x[0], inputs=example_quick_subjects, outputs=prompt,
            show_progress=False, queue=False)
    block.launch()
    return 0


def main(argv=None) -> int:
    from tclight_torch.pipeline.single_image import BGSource

    p = argparse.ArgumentParser()
    p.add_argument("--input", help="foreground image")
    p.add_argument("--prompt", default="best quality")
    p.add_argument("--bg_source", default="None",
                   choices=[b.value for b in BGSource])
    p.add_argument("--seed", type=int, default=12345)
    p.add_argument("--output", default="relit.png")
    p.add_argument("--serve", action="store_true", help="launch gradio UI")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # the UI's sliders: the working size (default: the longer side at 512)
    # and the step count
    p.add_argument("--image_width", type=int, default=None)
    p.add_argument("--image_height", type=int, default=None)
    p.add_argument("--steps", type=int, default=25)
    args = p.parse_args(argv)

    if args.serve:
        return serve(args.device)

    if not args.input:
        print("--input required (or --serve)")
        return 2
    import cv2
    import numpy as np

    relight = dataclasses.replace(build_relighter(args.device), steps=args.steps)
    img = cv2.cvtColor(cv2.imread(args.input), cv2.COLOR_BGR2RGB)
    out = relight.process(img.astype(np.float32) / 255.0, args.prompt,
                          BGSource(args.bg_source), args.seed,
                          image_width=args.image_width, image_height=args.image_height)
    cv2.imwrite(args.output, cv2.cvtColor((out * 255).astype(np.uint8),
                                          cv2.COLOR_RGB2BGR))
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
