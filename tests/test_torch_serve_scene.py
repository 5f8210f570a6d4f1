"""tools.serve_scene (port of tool/serve_scene.py) serves a scene directory:
'/' gives scene.html, .glb goes out as model/gltf-binary; as
tests/test_serve_scene.py holds the JAX tool."""
import threading
import urllib.request

from align3r_tpu_torch.tools import serve_scene


def test_serve_scene_serves_html_and_glb(tmp_path):
    (tmp_path / "scene.html").write_text("<html>ALIGN3R VIEWER</html>")
    (tmp_path / "scene.glb").write_bytes(b"glTF\x02\x00\x00\x00")
    with serve_scene.make_server(str(tmp_path), port=0) as srv:
        port = srv.server_address[1]
        t = threading.Thread(target=lambda: [srv.handle_request() for _ in range(2)],
                             daemon=True)
        t.start()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=10) as r:
            assert b"ALIGN3R VIEWER" in r.read()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/scene.glb", timeout=10) as r:
            assert r.headers["Content-Type"] == "model/gltf-binary"
            assert r.read().startswith(b"glTF")
        t.join(10)


def test_serve_scene_refuses_a_missing_directory(tmp_path):
    import pytest
    with pytest.raises(SystemExit):
        serve_scene.make_server(str(tmp_path / "missing"), port=0)
