"""Remote inference: an HTTP model server and its client.

Port of ``serve_model`` and ``RemoteModel`` in
``xlstm_yolo_tpu/utils/remote.py``, with the same wire protocol, so the
JAX client reads the port's server and the port's client the JAX one:

  GET  /meta   -> JSON {task, nc, names, imgsz, ...}
  POST /infer  -> request body: npz {"img": (B, H, W, 3) float32}
                  response body: npz {"out": (B, N, 4 + nc) float32}
                  a request that fails: HTTP 500 with JSON {"error": ...}

``serve_model`` holds any ``nn.autobackend.AutoBackend`` artifact on its
device (the card unless the caller asks for the CPU) and runs one warm-up
forward before it accepts a request. Stdlib only (``http.server``,
``urllib``).
"""
from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.request import Request, urlopen

import numpy as np


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _npz_load(data: bytes) -> dict:
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


class RemoteModel:
    """Client of a ``serve_model`` endpoint (or any server of the same npz
    protocol); ``url`` is ``http://host:port[/infer]``."""

    def __init__(self, url: str, timeout: float = 60.0):
        url = url.rstrip("/")
        if not url.endswith("/infer"):
            url = url + "/infer"
        self.url = url
        self.base = url[: -len("/infer")]
        self.timeout = timeout
        self.meta = self._fetch_meta()

    def _fetch_meta(self) -> dict:
        try:
            with urlopen(self.base + "/meta", timeout=self.timeout) as r:
                meta = json.loads(r.read().decode())
            if isinstance(meta.get("names"), dict):
                meta["names"] = {int(k): v for k, v in meta["names"].items()}
            return meta
        except Exception:  # noqa: BLE001 — a foreign server may lack /meta
            return {}

    def __call__(self, img: np.ndarray) -> np.ndarray:
        body = _npz_bytes(img=np.asarray(img, np.float32))
        req = Request(self.url, data=body, headers={"Content-Type": "application/x-npz"})
        with urlopen(req, timeout=self.timeout) as r:
            out = _npz_load(r.read())
        return out["out"]


def serve_model(weights, host: str = "127.0.0.1", port: int = 0, imgsz: int = 640,
                background: bool = True, device: str = "cuda"):
    """Serve an AutoBackend artifact over HTTP; returns the server
    (``server.server_address`` the bound (host, port), ``server.shutdown()``
    stops it, ``server.backend`` the model). ``background`` runs the loop
    in a daemon thread."""
    from ..nn.autobackend import AutoBackend

    backend = AutoBackend(weights, imgsz=imgsz, device=device).warmup()
    meta = {**backend.meta, "imgsz": imgsz}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.rstrip("/").endswith("meta") or self.path in ("", "/"):
                self._send(200, json.dumps(meta, default=str).encode(), "application/json")
            else:
                self._send(404, b"{}", "application/json")

        def do_POST(self):
            if not self.path.rstrip("/").endswith("infer"):
                self._send(404, b"{}", "application/json")
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                img = _npz_load(self.rfile.read(n))["img"]
                out = backend.forward(img)
                self._send(200, _npz_bytes(out=np.asarray(out, np.float32)),
                           "application/x-npz")
            except Exception as e:  # noqa: BLE001 — report, keep serving
                self._send(500, json.dumps({"error": str(e)[:200]}).encode(),
                           "application/json")

    server = ThreadingHTTPServer((host, port), Handler)
    server.backend = backend
    if background:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        server._thread = t
    else:
        server.serve_forever()
    return server
