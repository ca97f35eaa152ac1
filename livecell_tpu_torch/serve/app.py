"""Single-image inference server (counterpart of livecell_tpu/serve/app.py:
InferenceEngine, render_overlay, predict_single_image, launch_gradio,
launch_http, main).

Tile-sized inputs run one forward; frame-sized inputs are cut into the
standard 5x5 overlapping tiles, run as one batch and stitched. Either
model is served: the custom Mask R-CNN or the transfer R50-FPN, as the
checkpoint records. A port checkpoint is a directory holding `model.pt`
(a `torch.save`d state dict) and the `model_config.json` sidecar with
its `model_type` (train/checkpoint.py writes both, with the optimizer's
state beside them in a training checkpoint).

The engine is loaded once and cached across requests. The front end is
gradio where it is installed, else a stdlib HTTP server (POST an image,
get back the overlay PNG and the count); PIL, matplotlib and gradio are
imported only inside the functions that draw or serve.

    python -m livecell_tpu_torch.serve.app --model_path models/custom.ckpt
"""

from __future__ import annotations

import argparse
import io
import os
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from livecell_tpu_torch.config import (
    Config, TileConfig, add_dense_flags, apply_dense_flags)
from livecell_tpu_torch.config import model_type as type_of
from livecell_tpu_torch.device import resolve_device
from livecell_tpu_torch.models.mask_rcnn import create_model
from livecell_tpu_torch.models.transfer import create_transfer_model
from livecell_tpu_torch.ops.mask_ops import paste_masks
from livecell_tpu_torch.serve.stitch import (
    input_tile, make_frame_predictor, tile_position)
from livecell_tpu_torch.train import checkpoint

DEFAULT_MODEL_PATH = "models/custom_maskrcnn_5epochs.ckpt"


def save_model(model: nn.Module, path: str) -> None:
    """Write a port checkpoint directory (the model only) of either
    model."""
    checkpoint.save(path, model)


def load_model(path: str, device=None,
               model_type: Optional[str] = None) -> nn.Module:
    """Load a checkpoint directory, the port's or the JAX package's, onto
    `device` (the card unless the caller passes "cpu") as the serving
    model of the type it records. `model_type` types a JAX checkpoint
    that records none (the transfer trainer's) and must agree with one
    that does (train/checkpoint.py:load_model_state)."""
    kind, cfg, sd = checkpoint.load_model_state(path, device, model_type)
    build = create_model if kind == "custom" else create_transfer_model
    model = build(cfg, device=device)
    model.load_state_dict(sd, strict=True)
    return model


class InferenceEngine:
    """A model and its frame predictor, held for many requests.

    Pass a checkpoint directory (`model_path`) or a built `model` of
    either type; a `model_type` that disagrees with it raises. The dense
    flags (`dets`, `infer_nms`, `det_nms`) change a custom model's
    detection settings; a transfer model has none of them, so non-zero
    values raise. Runs on the card unless `device="cpu"`."""

    def __init__(self, model_path: Optional[str] = None, *,
                 model_type: Optional[str] = None,
                 model: Optional[nn.Module] = None, dets: int = 0,
                 infer_nms: float = 0.0, det_nms: float = 0.0,
                 tile_cfg: Optional[TileConfig] = None, device=None):
        if (model_path is None) == (model is None):
            raise ValueError("pass exactly one of model_path and model")
        self.device = resolve_device(device)
        self.model_path = model_path
        if model is None:
            model = load_model(model_path, self.device, model_type)
        kind = type_of(model.cfg)
        if model_type is not None and model_type != kind:
            raise ValueError(f"model_type {model_type!r}, but the model is "
                             f"{kind!r}")
        self.model_type = kind
        model = model.to(self.device).eval()
        if kind == "custom":
            model.cfg = apply_dense_flags(model.cfg, dets, infer_nms,
                                          det_nms)
        elif dets or infer_nms or det_nms:
            raise ValueError("dets, infer_nms and det_nms apply to the "
                             "custom model only")
        self.model = model
        self.cfg = Config(model=model.cfg, tile=tile_cfg or TileConfig())
        # score_threshold 0 here: each request filters with its own.
        self._frame_predict = make_frame_predictor(
            model, self.cfg.tile, score_threshold=0.0, mask_threshold=0.4,
            max_frame_dets=max(256, 4 * dets), device=self.device)

    @torch.inference_mode()
    def predict(self, image: np.ndarray, score_threshold: float = 0.5
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """image uint8 [H, W, 3] -> (boxes, scores, masks [N, H, W] bool)."""
        tcfg = self.cfg.tile
        h, w = image.shape[:2]

        if h >= tcfg.frame_height * 0.9 and w >= tcfg.frame_width * 0.9:
            # Frame-sized: overlapping tiles + dedup stitch.
            tiles = np.zeros((tcfg.num_tiles, tcfg.tile_height,
                              tcfg.tile_width, 3), np.uint8)
            for t in range(tcfg.num_tiles):
                c0, r0 = tile_position(t, tcfg.tiles_per_row)
                x0 = c0 * tcfg.mini_tile_width
                y0 = r0 * tcfg.mini_tile_height
                patch = image[y0:y0 + tcfg.tile_height,
                              x0:x0 + tcfg.tile_width]
                tiles[t, :patch.shape[0], :patch.shape[1]] = patch
            dets = self._frame_predict(tiles)
            keep = dets.scores > score_threshold
            masks = np.zeros((int(keep.sum()), h, w), bool)
            for i, k in enumerate(np.nonzero(keep)[0]):
                ox, oy = dets.offsets[k].astype(int)
                m = dets.masks[k]
                y1 = min(oy + m.shape[0], h)
                x1 = min(ox + m.shape[1], w)
                masks[i, oy:y1, ox:x1] = m[:y1 - oy, :x1 - ox]
            return dets.boxes[keep], dets.scores[keep], masks

        # Tile-sized: pad/crop into the model's input tile and run one
        # forward.
        ih, iw = input_tile(self.cfg.model)
        canvas = np.zeros((ih, iw, 3), np.float32)
        ch, cw = min(h, ih), min(w, iw)
        canvas[:ch, :cw] = image[:ch, :cw].astype(np.float32) / 255.0
        det = self.model.inference_forward(
            torch.from_numpy(canvas)[None].to(self.device))
        keep = det.valid[0] & (det.scores[0] > score_threshold)
        masks_full = paste_masks(det.mask_probs[0], det.boxes[0], (ih, iw),
                                 valid=keep)
        keep_np = keep.cpu().numpy()
        masks = masks_full.cpu().numpy()[keep_np][:, :h, :w] > 0
        return (det.boxes[0].cpu().numpy()[keep_np],
                det.scores[0].cpu().numpy()[keep_np], masks)


def render_overlay(image: np.ndarray, boxes, scores, masks) -> np.ndarray:
    """Colored mask overlay + per-instance score labels as an RGBA image
    (matplotlib, Agg)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(1, 1, figsize=(12, 10))
    ax.imshow(image)
    ax.axis("off")
    if len(boxes) > 0:
        h, w = image.shape[:2]
        overlay = np.zeros((h, w, 4), np.float32)
        for idx, (mask, score) in enumerate(zip(masks, scores)):
            color = plt.cm.tab20(idx % 20)
            overlay[mask, :3] = color[:3]
            overlay[mask, 3] = 0.5
            ys, xs = np.nonzero(mask)
            if len(ys):
                ax.text(xs.mean(), ys.mean(), f"{score:.2f}", color="white",
                        fontsize=8, fontweight="bold",
                        bbox=dict(facecolor="black", alpha=0.5,
                                  edgecolor="none"))
        ax.imshow(overlay)
    fig.canvas.draw()
    out = np.array(fig.canvas.renderer.buffer_rgba())
    plt.close(fig)
    return out


_ENGINE: Optional[InferenceEngine] = None
# The engine's settings from the CLI: the dense-scene overrides
# (--dets/--infer_nms/--det_nms) and the device, applied when the
# engine is (re)built.
_DENSE = {"dets": 0, "infer_nms": 0.0, "det_nms": 0.0, "device": None}


def predict_single_image(image: np.ndarray, model_path: str,
                         score_threshold: float):
    """The request handler: (overlay image, status line), with the engine
    cached across calls and rebuilt when the model path changes."""
    global _ENGINE
    if not os.path.exists(model_path):
        return image, f"Error: Model not found at {model_path}"
    try:
        if _ENGINE is None or _ENGINE.model_path != model_path:
            _ENGINE = InferenceEngine(model_path, **_DENSE)
    except Exception as e:
        return image, f"Error loading model: {e}"
    boxes, scores, masks = _ENGINE.predict(image, score_threshold)
    return render_overlay(image, boxes, scores, masks), \
        f"Detected {len(boxes)} cells."


def launch_gradio(model_path: str, port: int):
    import gradio as gr  # type: ignore

    with gr.Blocks(title="LiveCell Inference GUI") as demo:
        gr.Markdown("# Mask R-CNN Cell Detection")
        with gr.Row():
            with gr.Column():
                input_img = gr.Image(label="Input Image")
                model_path_input = gr.Textbox(
                    value=model_path, label="Path to model checkpoint")
                score_slider = gr.Slider(minimum=0.0, maximum=1.0,
                                         value=0.5, step=0.05,
                                         label="Confidence Threshold")
                run_btn = gr.Button("Run Detection", variant="primary")
            with gr.Column():
                output_img = gr.Image(label="Prediction Result")
                output_log = gr.Textbox(label="Status")
        run_btn.click(fn=predict_single_image,
                      inputs=[input_img, model_path_input, score_slider],
                      outputs=[output_img, output_log])
    demo.launch(server_name="0.0.0.0", server_port=port)


def launch_http(model_path: str, port: int):
    """Dependency-free server: GET / serves an upload form; POST
    /predict?threshold=0.5 with a raw or multipart image body returns
    the overlay PNG with the status line in its X-Status header; POST
    /shutdown stops it, so the process ends normally."""
    import threading
    from http.server import BaseHTTPRequestHandler, HTTPServer
    from urllib.parse import parse_qs, urlparse

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            print("[serve]", fmt % args)

        def do_GET(self):
            body = (b"<html><body><h1>LiveCell Inference</h1>"
                    b"<form method=post enctype=multipart/form-data "
                    b"action=/predict><input type=file name=image>"
                    b"<input type=submit></form></body></html>")
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if self.path.startswith("/shutdown"):
                body = b"shutting down"
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                threading.Thread(target=self.server.shutdown,
                                 daemon=True).start()
                return
            try:
                from PIL import Image

                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length)
                ctype = self.headers.get("Content-Type", "")
                if "multipart/form-data" in ctype:
                    # The first file payload of the form.
                    boundary = ctype.split("boundary=")[-1].encode()
                    payload = None
                    for part in raw.split(b"--" + boundary):
                        if b"\r\n\r\n" in part and b"filename=" in part:
                            payload = part.split(b"\r\n\r\n", 1)[1]
                            payload = payload.rsplit(b"\r\n", 1)[0]
                            break
                    raw = payload or raw
                img = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
                q = parse_qs(urlparse(self.path).query)
                thr = float(q.get("threshold", ["0.5"])[0])
                out, status = predict_single_image(img, model_path, thr)
                buf = io.BytesIO()
                Image.fromarray(out).save(buf, format="PNG")
                data = buf.getvalue()
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("X-Status", status)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            except Exception as e:
                msg = f"error: {e}".encode()
                self.send_response(500)
                self.send_header("Content-Length", str(len(msg)))
                self.end_headers()
                self.wfile.write(msg)

    print(f"Starting HTTP inference server on port {port} "
          f"(gradio unavailable)...")
    server = HTTPServer(("0.0.0.0", port), Handler)
    try:
        server.serve_forever()  # returns after POST /shutdown
    finally:
        server.server_close()


def main(argv=None, device=None):
    """Serve `--model_path` on `--port`: gradio if it imports, else the
    HTTP server. Runs on the card unless the caller passes
    device="cpu"."""
    parser = argparse.ArgumentParser(description="LiveCell inference GUI")
    parser.add_argument("--model_path", type=str,
                        default=DEFAULT_MODEL_PATH)
    parser.add_argument("--port", type=int, default=7860)
    add_dense_flags(parser)
    args = parser.parse_args(argv)
    _DENSE.update(dets=args.dets, infer_nms=args.infer_nms,
                  det_nms=args.det_nms, device=resolve_device(device))

    try:
        import gradio  # noqa: F401
    except ImportError:
        launch_http(args.model_path, args.port)
    else:
        launch_gradio(args.model_path, args.port)


if __name__ == "__main__":
    main()
