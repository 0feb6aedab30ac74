"""Serving: a render session that keeps the model and scene resident, and a
minimal HTTP front end (counterpart of nerftex_tpu/render/serve.py).

  - ``RenderSession``: load a render config (the dict the CLI uses), apply
    an operating point, restore the latest checkpoint once, then
    ``render(camera_pos, parameters, ...) -> RGBA``.  Pixel rays and the
    proxy slab test run on the session's device; per request only the pose
    and the parameters cross from the host.
  - ``python -m nerftex_torch.render.serve <config> --op grass``: stdlib
    HTTP wrapper; POST /render with JSON {"camera_pos": [x, y, z],
    "parameters": [...], "radius": r} returns a PNG, GET /healthz reports
    liveness.

Requests draw their random numbers as the JAX package's session does: the
renderer's n-th call renders under rng.stream_key(STREAM_PERTURB, n) from
the config's seed, so a session serves the JAX package's frames.
"""

import importlib
import json
import os
import sys

import numpy as np
import torch

from nerftex_torch import operating_points
from nerftex_torch.ops.rays import look_at, rays_from_camera_device
from nerftex_torch.render.checkpoint import CheckpointManager, load_jax_params
from nerftex_torch.utils import rng, trace
from nerftex_torch.utils.image import encode_png
from nerftex_torch.utils.util import EasyDict, instantiate, resolve_device


def straight_rgba(color, alpha, height, width) -> np.ndarray:
    """A frame's premultiplied color [.., 3] and alpha [..] as float32
    straight-alpha RGBA [H, W, 4], clipped to [0, 1]."""
    img = np.concatenate([np.asarray(color, np.float32).reshape(-1, 3),
                          np.asarray(alpha, np.float32).reshape(-1, 1)], -1)
    img = img.reshape(height, width, 4)
    img[..., :3] = img[..., :3] / (img[..., 3:] + 1e-5)
    return np.clip(img, 0, 1)


class RenderSession:
    """Checkpoint-resident instanced renderer answering pose/parameter
    queries."""

    def __init__(self, config: dict, height: int = None, width: int = None, warmup: bool = False,
                 render_chunk: int = None, operating_point=None, device=None):
        """render_chunk: rays per renderer chunk, by default the whole frame.

        operating_point: None (the raw config), a scene stem ('carpet',
        'grass', 'plush', resolved through nerftex_torch.operating_points)
        or a dict shaped like an OPERATING_POINTS entry.

        device: where the session renders; CUDA unless given."""
        self.device = resolve_device(device)
        config = EasyDict(config)
        rng.set_seed(config.get("seed"))

        if isinstance(operating_point, str):
            resolved = operating_points.resolve(operating_point)
            if resolved is None:
                raise ValueError(f"no adopted operating point for scene {operating_point!r}")
            operating_point = resolved
        self.operating_point = operating_point

        loader = config.test_dataset_config.data_loader_config
        self.height = height or loader.get("height", 512)
        self.width = width or loader.get("width", 512)
        self.angle = loader.get("angle", 0.63)
        self.default_radius = loader.get("radius", 5.0)
        if isinstance(self.default_radius, dict):
            self.default_radius = 5.0
        pdist = instantiate(EasyDict(loader["parameter_dist_config"]))
        self.default_parameters = np.asarray(pdist(), np.float32)
        self.proxy = instantiate(EasyDict(config.test_dataset_config.proxy_config))

        model_config = EasyDict(config.model_config)
        model_config.setdefault("n_parameters", len(self.default_parameters))
        renderer_config = EasyDict(config.renderer_config)
        if operating_point:
            model_config["compute_dtype"] = operating_point.get(
                "compute_dtype", model_config.get("compute_dtype", "float32"))
            renderer_config.update(operating_point.get("renderer", {}))
            renderer_config.instancer_config = EasyDict(renderer_config.instancer_config)
            renderer_config.instancer_config.update(operating_point.get("instancer", {}))
        model = instantiate(model_config, device=self.device)
        self.models = {model.name: model}

        # Restore the latest checkpoint (model weights only, as the JAX
        # package's render mode does).
        source = config.get("source_path") or config.target_path
        manager = CheckpointManager(os.path.join(source, "checkpoints"))
        saved = manager.restore_latest()
        if saved:
            for name, m in self.models.items():
                if name in saved.get("models", {}):
                    load_jax_params(m, saved["models"][name])
        else:
            # Random-init weights are almost never what a server should show.
            print(f"WARNING: RenderSession found no checkpoint under "
                  f"{os.path.join(source, 'checkpoints')!r}; serving random-init weights.",
                  flush=True)
        self.restored_from = manager.latest_checkpoint

        renderer_config.update(self.models)
        self.renderer = instantiate(renderer_config, device=self.device)
        self.renderer.render_chunk = render_chunk or self.height * self.width

        self._focal = self.width / np.tan(self.angle / 2) / 2
        self._pixels = None
        self._frame = 0
        if warmup:
            self.render([0.47, -0.65, 0.6])
            self._frame = 0

    def pose(self, camera_pos, radius=None, look_at_point=(0, 0, 0.0)) -> np.ndarray:
        """Camera-to-world [4, 4] of a request: camera_pos is a position, or
        a unit-ish direction scaled by radius (by the config's radius when
        its norm is below 2)."""
        pos = np.asarray(camera_pos, np.float64)
        if radius is not None:
            pos = pos * radius
        elif np.linalg.norm(pos) < 2.0:
            pos = pos * self.default_radius
        return look_at(pos, to=np.asarray(look_at_point, np.float64))

    @trace.span("session.rays")
    def device_rays(self, pose):
        """Whole-frame rays of ``pose`` on the session's device: (rays_o,
        rays_d normalized, proxy t, cone_scale), each [H*W, ...]."""
        h, w = self.height, self.width
        if self._pixels is None:
            idx = torch.arange(h * w, device=self.device)
            self._pixels = torch.stack([idx // w, idx % w], -1).float()
        rays_o, rays_d, cone = rays_from_camera_device(self._pixels, h, w, self._focal, pose)
        rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        return rays_o, rays_d, self.proxy(rays_o, rays_d), cone

    @trace.span("session.render")
    def render(self, camera_pos, parameters=None, radius=None, look_at=(0, 0, 0.0)):
        """One frame at ``camera_pos`` as float32 [H, W, 4] straight-alpha
        RGBA."""
        pose = self.pose(camera_pos, radius, look_at)
        if parameters is None:
            parameters = self.default_parameters
        parameters = np.asarray(parameters, np.float32)
        rays_o, rays_d, t, cone = self.device_rays(pose)
        self._frame += 1
        out = self.renderer(rays_o=rays_o[None], rays_d=rays_d[None], t=t[None],
                            parameters=parameters[None], cone_scale=cone[None], training=False)
        with trace.host_read("readback"):
            color = out["color_pred"].cpu().numpy()
        with trace.host_read("readback"):
            alpha = out["alpha_pred"].cpu().numpy()
        return straight_rgba(color, alpha, self.height, self.width)


# ---------------------------------------------------------------------------
# HTTP front end (stdlib only)
# ---------------------------------------------------------------------------


def make_handler(session: RenderSession):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, code, content_type, body):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                self.send_error(404)
                return
            self._send(200, "application/json", json.dumps({
                "status": "ok", "checkpoint": session.restored_from,
                "resolution": [session.height, session.width],
                "frames_served": session._frame,
            }).encode())

        def do_POST(self):
            if self.path != "/render":
                self.send_error(404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                img = session.render(req.get("camera_pos", [0.47, -0.65, 0.6]),
                                     parameters=req.get("parameters"), radius=req.get("radius"),
                                     look_at=req.get("look_at", (0, 0, 0.0)))
            except Exception as e:  # errors come back as 400s with a message
                self._send(400, "application/json", json.dumps({"error": str(e)}).encode())
                return
            self._send(200, "image/png", encode_png(img))

    return Handler


def main():
    import argparse
    from http.server import HTTPServer

    ap = argparse.ArgumentParser(description="Serve instanced renders over HTTP.")
    ap.add_argument("config", help="render config path (e.g. configs/config_grass_render.py)")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the warming render at startup")
    ap.add_argument("--op", default="auto",
                    help="render operating point: 'auto' (infer the scene from the config "
                         "name, else the raw config), 'none' (the raw config), or a scene "
                         "stem from nerftex_torch.operating_points")
    args = ap.parse_args()

    if os.getcwd() not in sys.path:
        sys.path.insert(0, os.getcwd())
    config_path = args.config[:-3] if args.config.endswith(".py") else args.config
    config = importlib.import_module(config_path.replace("/", ".")).config

    if args.op == "auto":
        scene = operating_points.infer_scene(args.config)
        op = operating_points.resolve(scene) if scene else None
        print(f"operating point: {scene if op else 'raw config'}")
    elif args.op == "none":
        op = None
    else:
        op = args.op  # a scene stem; RenderSession raises if unknown

    session = RenderSession(config, height=args.height, width=args.width,
                            warmup=not args.no_warmup, operating_point=op)
    print(f"restored: {session.restored_from}")
    server = HTTPServer(("127.0.0.1", args.port), make_handler(session))
    print(f"serving on http://127.0.0.1:{args.port} (/render, /healthz)")
    server.serve_forever()


if __name__ == "__main__":
    main()
