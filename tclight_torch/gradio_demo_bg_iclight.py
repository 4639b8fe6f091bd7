"""IC-Light background-conditioned demo of the PyTorch port (fbc, 12-channel;
counterpart of the root gradio_demo_bg_iclight.py, with its arguments): RMBG
preprocessing, the background sources (upload, flipped, ramps, ambient),
the high-resolution pass and the Compute Normal mode. `--serve` launches
the gradio UI (gradio is imported only then); otherwise it relights one
image and writes it.

Usage (headless, on the card; `--device cpu` for the CPU):
    python -m tclight_torch.gradio_demo_bg_iclight --fg fg.png --bg bg.png \
        -p "studio light" --output out.png

Weights: IC-Light fbc from ICLIGHT_MODEL_DIR, else the tiny random stack;
BriaRMBG from RMBG_CKPT (see tclight_torch.gradio_demo_iclight).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

quick_prompts = [
    "beautiful woman",
    "handsome man",
    "beautiful woman, cinematic lighting",
    "handsome man, cinematic lighting",
    "beautiful woman, natural lighting",
    "handsome man, natural lighting",
    "beautiful woman, neo punk lighting, cyberpunk",
    "handsome man, neo punk lighting, cyberpunk",
]


def build_relighter(device: str = "cuda"):
    from tclight_torch.gradio_demo_iclight import build_relighter as build

    return build(device, mode="fbc")


def make_handlers(relight, rmbg):
    """process_relight / process_normal with the reference's signatures
    (gradio_demo_bg_iclight.py:327-381)."""
    import numpy as np

    from tclight_torch.pipeline.single_image import (
        BGSourceFBC,
        normals_from_relights,
        resize_and_center_crop,
        run_rmbg_composite,
    )

    def _prep_fg(input_fg, sigma=0.0):
        fg = input_fg.astype(np.float32) / 255.0
        matting = None
        if rmbg is not None:
            fg, matting = run_rmbg_composite(rmbg, fg, sigma)
        return fg, matting

    def _run(fg, input_bg, prompt, image_width, image_height, num_samples,
             seed, steps, a_prompt, n_prompt, cfg, highres_scale,
             highres_denoise, bg_source):
        bg = None if input_bg is None else input_bg.astype(np.float32) / 255.0
        r = dataclasses.replace(
            relight, steps=int(steps), guidance_scale=float(cfg),
            added_prompt=a_prompt, negative_prompt=n_prompt)
        outs = []
        for i in range(int(num_samples)):
            out = r.process_bg(
                fg, bg, prompt, BGSourceFBC(bg_source), int(seed) + i,
                highres_scale=float(highres_scale),
                highres_denoise=float(highres_denoise),
                image_width=int(image_width), image_height=int(image_height),
            )
            outs.append(out)
        return outs

    def process_relight(input_fg, input_bg, prompt, image_width, image_height,
                        num_samples, seed, steps, a_prompt, n_prompt, cfg,
                        highres_scale, highres_denoise, bg_source):
        fg, _ = _prep_fg(input_fg)
        outs = _run(fg, input_bg, prompt, image_width, image_height,
                    num_samples, seed, steps, a_prompt, n_prompt, cfg,
                    highres_scale, highres_denoise, bg_source)
        return [(x * 255.0).clip(0, 255).astype(np.uint8) for x in outs]

    def process_normal(input_fg, input_bg, prompt, image_width, image_height,
                       num_samples, seed, steps, a_prompt, n_prompt, cfg,
                       highres_scale, highres_denoise, bg_source):
        fg, matting = _prep_fg(input_fg, sigma=16.0)
        dirs = {}
        for name in ("LEFT", "RIGHT", "BOTTOM", "TOP"):
            print(f"{name.lower()} ...")
            dirs[name] = _run(
                fg, input_bg, prompt, image_width, image_height, 1, seed,
                steps, a_prompt, n_prompt, cfg, highres_scale,
                highres_denoise, BGSourceFBC[name].value)[0]
        h, w, _ = dirs["LEFT"].shape
        if matting is None:
            matting = np.ones((h, w, 1), np.float32)
        else:
            m8 = (matting[..., 0] * 255.0).clip(0, 255).astype(np.uint8)
            matting = resize_and_center_crop(m8, w, h)
            matting = matting.astype(np.float32)[..., None] / 255.0
        normal, ratios = normals_from_relights(
            dirs["LEFT"], dirs["RIGHT"], dirs["BOTTOM"], dirs["TOP"], matting)
        inner = [dirs[k] * 2.0 - 1.0
                 for k in ("LEFT", "RIGHT", "BOTTOM", "TOP")]
        results = [normal] + ratios + inner
        return [(x * 127.5 + 127.5).clip(0, 255).astype(np.uint8)
                for x in results]

    return process_relight, process_normal


def serve(device: str = "cuda") -> int:
    try:
        import gradio as gr
    except ImportError:
        print("gradio is not installed; run headless with --fg/--bg")
        return 1

    import db_examples
    from tclight_torch.gradio_demo_iclight import build_rmbg
    from tclight_torch.pipeline.single_image import BGSourceFBC

    relight = build_relighter(device)
    process_relight, process_normal = make_handlers(relight, build_rmbg(device))

    block = gr.Blocks().queue()
    with block:
        with gr.Row():
            gr.Markdown("## IC-Light "
                        "(Relighting with Foreground and Background Condition)")
        with gr.Row():
            with gr.Column():
                with gr.Row():
                    input_fg = gr.Image(type="numpy", label="Foreground",
                                        height=480)
                    input_bg = gr.Image(type="numpy", label="Background",
                                        height=480)
                prompt = gr.Textbox(label="Prompt")
                bg_source = gr.Radio(
                    choices=[e.value for e in BGSourceFBC],
                    value=BGSourceFBC.UPLOAD.value,
                    label="Background Source", type="value")
                example_prompts = gr.Dataset(
                    samples=[[x] for x in quick_prompts],
                    label="Prompt Quick List", components=[prompt])
                bg_list = db_examples.available_paths(db_examples.bg_samples)
                bg_gallery = gr.Gallery(
                    height=450, object_fit="contain",
                    label="Background Quick List", value=bg_list or None,
                    columns=5, allow_preview=False)
                relight_button = gr.Button(value="Relight")

                with gr.Group():
                    with gr.Row():
                        num_samples = gr.Slider(label="Images", minimum=1,
                                                maximum=12, value=1, step=1)
                        seed = gr.Number(label="Seed", value=12345,
                                         precision=0)
                    with gr.Row():
                        image_width = gr.Slider(label="Image Width",
                                                minimum=256, maximum=1024,
                                                value=512, step=64)
                        image_height = gr.Slider(label="Image Height",
                                                 minimum=256, maximum=1024,
                                                 value=640, step=64)
                with gr.Accordion("Advanced options", open=False):
                    steps = gr.Slider(label="Steps", minimum=1, maximum=100,
                                      value=20, step=1)
                    cfg = gr.Slider(label="CFG Scale", minimum=1.0,
                                    maximum=32.0, value=7.0, step=0.01)
                    highres_scale = gr.Slider(label="Highres Scale",
                                              minimum=1.0, maximum=3.0,
                                              value=1.5, step=0.01)
                    highres_denoise = gr.Slider(label="Highres Denoise",
                                                minimum=0.1, maximum=0.9,
                                                value=0.5, step=0.01)
                    a_prompt = gr.Textbox(label="Added Prompt",
                                          value="best quality")
                    n_prompt = gr.Textbox(
                        label="Negative Prompt",
                        value="lowres, bad anatomy, bad hands, "
                              "cropped, worst quality")
                    normal_button = gr.Button(
                        value="Compute Normal (4x Slower)")
            with gr.Column():
                result_gallery = gr.Gallery(height=832, object_fit="contain",
                                            label="Outputs")
        rows = db_examples.available(
            db_examples.background_conditioned_examples, img_cols=(0, 1))
        if rows:
            dummy_image_for_outputs = gr.Image(visible=False, label="Result")
            gr.Examples(
                fn=lambda *a: [a[-1]],
                examples=rows,
                inputs=[input_fg, input_bg, prompt, bg_source, image_width,
                        image_height, seed, dummy_image_for_outputs],
                outputs=[result_gallery],
                run_on_click=True, examples_per_page=1024,
            )
        ips = [input_fg, input_bg, prompt, image_width, image_height,
               num_samples, seed, steps, a_prompt, n_prompt, cfg,
               highres_scale, highres_denoise, bg_source]
        relight_button.click(fn=process_relight, inputs=ips,
                             outputs=[result_gallery])
        normal_button.click(fn=process_normal, inputs=ips,
                            outputs=[result_gallery])
        example_prompts.click(lambda x: x[0], inputs=example_prompts,
                              outputs=prompt, show_progress=False, queue=False)

        def bg_gallery_selected(gal, evt: gr.SelectData):
            return gal[evt.index]["name"]

        bg_gallery.select(bg_gallery_selected, inputs=bg_gallery,
                          outputs=input_bg)
    block.launch()
    return 0


def main(argv=None) -> int:
    from tclight_torch.pipeline.single_image import BGSourceFBC

    p = argparse.ArgumentParser()
    p.add_argument("--fg", help="foreground image")
    p.add_argument("--bg", help="background image")
    p.add_argument("-p", "--prompt", default="best quality")
    p.add_argument("--bg_source", default=BGSourceFBC.UPLOAD.value,
                   choices=[b.value for b in BGSourceFBC])
    p.add_argument("--seed", type=int, default=12345)
    p.add_argument("--output", default="relit_bg.png")
    p.add_argument("--serve", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # the UI's sliders: the working size (default: the longer side at 512)
    # and the step count
    p.add_argument("--image_width", type=int, default=None)
    p.add_argument("--image_height", type=int, default=None)
    p.add_argument("--steps", type=int, default=25)
    args = p.parse_args(argv)

    if args.serve:
        return serve(args.device)

    need_bg = args.bg_source in (BGSourceFBC.UPLOAD.value,
                                 BGSourceFBC.UPLOAD_FLIP.value)
    if not (args.fg and (args.bg or not need_bg)):
        print("--fg required, and --bg for upload background sources "
              "(or --serve)")
        return 2
    import cv2
    import numpy as np

    relight = dataclasses.replace(build_relighter(args.device), steps=args.steps)
    fg = cv2.cvtColor(cv2.imread(args.fg), cv2.COLOR_BGR2RGB)
    bg = None
    if args.bg:
        bg = cv2.cvtColor(cv2.imread(args.bg), cv2.COLOR_BGR2RGB)
        bg = bg.astype(np.float32) / 255.0
    out = relight.process_bg(
        fg.astype(np.float32) / 255.0, bg, args.prompt,
        BGSourceFBC(args.bg_source), args.seed,
        image_width=args.image_width, image_height=args.image_height,
    )
    cv2.imwrite(args.output, cv2.cvtColor((out * 255).astype(np.uint8),
                                          cv2.COLOR_RGB2BGR))
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
