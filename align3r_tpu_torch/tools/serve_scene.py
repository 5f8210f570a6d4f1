"""Serve a reconstruction output directory over HTTP (port of
tool/serve_scene.py; standard library only).

The reference serves its result through gradio (dust3r/demo.py:283); the
port's result is a static page (``eval/html_viewer.py``'s scene.html, WebGL)
and a ``scene.glb``, so the standard-library HTTP server is enough: point it
at a ``tools.demo`` output directory and open the printed URL.

    python -m align3r_tpu_torch.tools.serve_scene OUT_DIR [--port 7860] [--host 127.0.0.1]
"""
from __future__ import annotations

import argparse
import functools
import http.server
import os
import sys


def make_server(out_dir: str, host: str = "127.0.0.1", port: int = 7860):
    """A ThreadingHTTPServer rooted at out_dir: '/' serves scene.html (else
    index.html), .glb goes out as model/gltf-binary; port 0 takes a free
    port."""
    root = os.path.abspath(out_dir)
    if not os.path.isdir(root):
        raise SystemExit(f"not a directory: {root}")
    index = next((f for f in ("scene.html", "index.html")
                  if os.path.exists(os.path.join(root, f))), None)

    class Handler(http.server.SimpleHTTPRequestHandler):
        extensions_map = dict(http.server.SimpleHTTPRequestHandler.extensions_map,
                              **{".glb": "model/gltf-binary"})

        def do_GET(self):  # noqa: N802 - http.server's name
            if self.path in ("", "/") and index:
                self.path = "/" + index
            return super().do_GET()

        def log_message(self, fmt, *a):
            sys.stderr.write("[serve] " + fmt % a + "\n")

    handler = functools.partial(Handler, directory=root)
    return http.server.ThreadingHTTPServer((host, port), handler)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir", help="a tools.demo output directory (scene.html, scene.glb)")
    ap.add_argument("--port", type=int, default=7860)    # gradio's default
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--once", action="store_true", help="answer one request and exit")
    args = ap.parse_args(argv)
    with make_server(args.out_dir, args.host, args.port) as srv:
        host, port = srv.server_address[:2]
        print(f"serving {os.path.abspath(args.out_dir)} at http://{host}:{port}/", flush=True)
        if args.once:
            srv.handle_request()
        else:
            srv.serve_forever()


if __name__ == "__main__":
    main()
