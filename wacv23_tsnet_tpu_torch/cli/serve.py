"""Minimal HTTP retargeting server over streaming sessions (counterpart
of the JAX package's `cli/serve.py`: the same API, flags and status
codes).

A client registers a subject once (the reference frames are encoded on
the GPU and stay there), then streams driving keypoints and gets
synthesized frames back. One lock owns the GPU; requests queue behind it.
A `Server` of a pose config takes the pose task's OpenPose points
through the same routes; the command line serves the face model.

    python -m wacv23_tsnet_tpu_torch.cli.serve --port 8787 \
        [--restore-from ckpt.msgpack]

`--restore-from` takes the JAX package's files as they are: a flax
msgpack generator file, a full trainer snapshot or a reference `.pth`.

API (JSON in, JSON out):
  POST /session   {"src_img": [S,H,W,3] uint8-list (raw BGR),
                   "src_lbl": [S,H,W] class-map list,
                   "src_bbox": [S,H,W] 0/1 list}       -> {"session": id}
  POST /frames    {"session": id, "keypoints": [F,68,2]}
                  (pose: [F,137,2], pose|face|hand_l|hand_r, 0 = missing)
                  -> {"frames": [F,H,W,3] uint8 RGB list, "ms": float}
                  with "encoding": "base64" -> {"frames_b64": ...,
                  "shape": [F,H,W,3], "dtype": "uint8", "ms": float}
  GET  /healthz   -> {"ok": true, "backend": "cuda" | "cpu", "sessions": n}
Unknown paths and sessions give 404, malformed input 400.
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..device import resolve_device
from ..infer.streaming import RetargetSession
from ..models import TSNetModules


class Server:
    def __init__(self, cfg, mods: TSNetModules, chunk: int = 32):
        """Sessions of `cfg` on `mods` (built for `cfg`), on their
        device."""
        if mods.cfg != cfg:
            raise ValueError("the modules were built for another config")
        self.cfg = cfg
        self.mods = mods
        self.device = resolve_device(mods.device)
        self.chunk = chunk
        self.sessions: dict = {}
        self.lock = threading.Lock()   # one worker owns the GPU

    def session_inputs(self, payload: dict) -> tuple:
        """A /session payload as the session's (src_img model space,
        src_lbl one-hot, src_bbox) numpy arrays."""
        mean = self.cfg.img_mean_array()
        src_u8 = np.asarray(payload["src_img"], np.uint8)      # (S,H,W,3) BGR
        src_img = (src_u8.astype(np.float32) - mean) / 255.0
        src_lbl = (np.asarray(payload["src_lbl"], np.uint8)[..., None]
                   == np.arange(self.cfg.label_nc)).astype(np.float32)
        src_bbox = np.asarray(payload["src_bbox"], np.float32)
        return src_img, src_lbl, src_bbox

    def create_session(self, payload: dict) -> str:
        inputs = self.session_inputs(payload)
        with self.lock:
            # frames come back from the device as uint8 display frames
            session = RetargetSession(self.mods, *inputs, chunk=self.chunk,
                                      output="display", device=self.device)
        sid = uuid.uuid4().hex[:12]
        self.sessions[sid] = session
        return sid

    def run_frames(self, payload: dict) -> dict:
        session = self.sessions[payload["session"]]
        kp = np.asarray(payload["keypoints"], np.float32)
        t0 = time.perf_counter()
        with self.lock:
            rec = session.push_keypoints(kp)   # (F, H, W, 3) uint8 BGR
        rgb = np.ascontiguousarray(rec[..., ::-1])   # BGR -> RGB
        ms = (time.perf_counter() - t0) * 1e3
        if payload.get("encoding") == "base64":
            return {"frames_b64": base64.b64encode(rgb.tobytes()).decode(),
                    "shape": list(rgb.shape), "dtype": "uint8", "ms": ms}
        return {"frames": rgb.tolist(), "ms": ms}


def make_handler(server: Server):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):   # quiet
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True,
                                  "backend": server.device.type,
                                  "sessions": len(server.sessions)})
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(length))
                if self.path == "/session":
                    self._reply(200, {"session":
                                      server.create_session(payload)})
                elif self.path == "/frames":
                    if payload.get("session") not in server.sessions:
                        self._reply(404, {"error": "unknown session"})
                        return
                    self._reply(200, server.run_frames(payload))
                else:
                    self._reply(404, {"error": "not found"})
            except (KeyError, ValueError, TypeError) as exc:
                self._reply(400, {"error": str(exc)})

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--restore-from", default="")
    p.add_argument("--chunk", type=int, default=32)
    p.add_argument("--precision", default="high")
    p.add_argument("--fast-trunk", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="encoders in one bf16 pass (the bench tier)")
    p.add_argument("--fast-tail", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="bf16 FuseNet and decoder (the bench tier)")
    p.add_argument("--toy", action="store_true",
                   help="64x64 toy config (fast smoke serving)")
    args = p.parse_args(argv)

    from ..configs import face_config, toy_config
    from .demo_face import load_params

    base = toy_config() if args.toy else face_config()
    cfg = dataclasses.replace(base, precision=args.precision,
                              fast_tail=args.fast_tail,
                              fast_trunk=args.fast_trunk)
    mods = load_params(args.restore_from, cfg, device="cuda")
    server = Server(cfg, mods, chunk=args.chunk)
    httpd = ThreadingHTTPServer(("127.0.0.1", args.port),
                                make_handler(server))
    print(f"serving on http://127.0.0.1:{args.port} "
          f"(task={cfg.task}, {cfg.image_size}^2, {mods.device})")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
