"""The port's wire surface against the JAX package's: the raw-tensor
codec both ways, PNG bytes, ``multipart/form-data`` both ways (the JAX
package's side is ``aiohttp``), the retrying sender and the wire-format
negotiation."""

import asyncio
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from comfyui_distributed_tpu.utils import image as jimg
from comfyui_distributed_tpu_torch.server.app import ServerState, make_server
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils import net
from comfyui_distributed_tpu_torch.utils.image import (decode_png,
                                                       decode_tensor,
                                                       encode_png,
                                                       encode_tensor,
                                                       to_uint8)


def _img(shape=(1, 24, 20, 3), seed=0):
    return np.random.default_rng(seed).uniform(
        -0.1, 1.1, size=shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(1, 24, 20, 3), (2, 8, 8, 3),
                                   (17, 9, 3)])
def test_tensor_codec_both_ways_exactly(shape):
    x = _img(shape)
    want = x if x.ndim == 4 else x[None]
    ours = encode_tensor(x)
    theirs = jimg.encode_tensor(x, "zlib")
    assert ours == theirs
    np.testing.assert_array_equal(decode_tensor(theirs), want)
    np.testing.assert_array_equal(jimg.decode_tensor(ours), want)
    assert decode_tensor(ours).dtype == np.float32


def test_tensor_codec_refuses_what_it_cannot_decode():
    data = encode_tensor(_img())
    with pytest.raises(ValueError):
        decode_tensor(b"XXXX" + data[4:])
    with pytest.raises(ValueError):
        decode_tensor(data[:4] + bytes([2]) + data[5:])
    with pytest.raises(ValueError):
        encode_tensor(_img(), "zstd")


@pytest.mark.parametrize("level", [0, 6])
def test_port_reads_jax_png(level):
    x = _img()
    got = decode_png(jimg.encode_png(x, compress_level=level))
    np.testing.assert_array_equal(got, to_uint8(x).astype(np.float32)
                                  / 255.0)
    # and the other way: the JAX package reads the port's file
    np.testing.assert_array_equal(jimg.decode_png(encode_png(x)), got)


def test_png_text_chunk():
    """Pillow reads the port's ``tEXt`` chunk, as ComfyUI reads a saved
    image's ``prompt``."""
    import io

    from PIL import Image
    data = encode_png(_img()[0], {"prompt": json.dumps({"3": {"a": 1}})})
    assert json.loads(Image.open(io.BytesIO(data)).text["prompt"]) \
        == {"3": {"a": 1}}


PAYLOAD = bytes(range(256)) * 3 + b"\r\n--not-a-boundary\r\n"


def _aiohttp_body():
    import aiohttp
    fd = aiohttp.FormData()
    fd.add_field("multi_job_id", "exec_1_14")
    fd.add_field("image_index", "3")
    fd.add_field("image", PAYLOAD, filename="img_3.dtt",
                 content_type=C.TENSOR_WIRE_CONTENT_TYPE)
    writer = fd()

    class Sink:
        data = b""

        async def write(self, chunk):
            Sink.data += chunk

    asyncio.run(writer.write(Sink()))
    return Sink.data, writer.headers["Content-Type"]


def test_port_reads_an_aiohttp_form():
    body, ctype = _aiohttp_body()
    form = net.parse_multipart(body, ctype)
    assert form["multi_job_id"].text == "exec_1_14"
    assert form["image_index"].text == "3"
    assert form["image"].data == PAYLOAD
    assert form["image"].filename == "img_3.dtt"
    assert form["image"].content_type == C.TENSOR_WIRE_CONTENT_TYPE


def test_aiohttp_reads_the_port_form():
    """aiohttp's ``request.post()`` (what the JAX package's master runs)
    on the port's form, sent over a socket by the port's sender."""
    from aiohttp import web
    from aiohttp.test_utils import TestServer
    seen = {}

    async def handler(request):
        form = await request.post()
        for k, v in form.items():
            seen[k] = v if isinstance(v, str) else (
                v.filename, v.content_type, v.file.read())
        return web.json_response({"status": "ok"})

    def make():
        f = net.FormData()
        f.add_field("multi_job_id", "exec_1_2")
        f.add_field("is_last", "true")
        f.add_field("tile", PAYLOAD, filename="tile_5.png",
                    content_type="image/png")
        return f

    async def main():
        app = web.Application(client_max_size=1 << 24)
        app.router.add_post("/distributed/tile_complete", handler)
        server = TestServer(app, host="127.0.0.1")
        await server.start_server()
        try:
            await asyncio.get_running_loop().run_in_executor(
                None, lambda: net.post_form_with_retry(
                    str(server.make_url("/distributed/tile_complete")), make,
                    timeout=10, max_retries=1))
        finally:
            await server.close()

    asyncio.run(main())
    assert seen == {"multi_job_id": "exec_1_2", "is_last": "true",
                    "tile": ("tile_5.png", "image/png", PAYLOAD)}


class _Flaky(BaseHTTPRequestHandler):
    """404 for the first ``fails`` POSTs, then 200; records each body."""
    fails = 2
    bodies = []

    def do_POST(self):
        _Flaky.bodies.append(self.rfile.read(
            int(self.headers["Content-Length"])))
        code = 404 if len(_Flaky.bodies) <= _Flaky.fails else 200
        self.send_response(code)
        if code != 200 and len(_Flaky.bodies) == 1:
            self.send_header("Retry-After", "0")
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"{}")

    def log_message(self, *a):
        pass


@pytest.fixture
def flaky():
    _Flaky.bodies = []
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Flaky)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def test_post_form_with_retry_retries_404(flaky, monkeypatch):
    monkeypatch.setattr(C, "SEND_BACKOFF_BASE", 0.01)
    sent = []

    def make():
        f = net.FormData()
        f.add_field("n", str(len(sent)))
        sent.append(f)
        return f

    net.post_form_with_retry(flaky + "/x", make, timeout=5)
    assert len(_Flaky.bodies) == 3 and len(sent) == 3   # a new form a try
    _Flaky.bodies, _Flaky.fails = [], 9
    with pytest.raises(RuntimeError, match="404"):
        net.post_form_with_retry(flaky + "/x", make, timeout=5,
                                 max_retries=2)
    _Flaky.fails = 2


def test_backoff_is_exponential_jittered_and_capped():
    class Lo:
        @staticmethod
        def uniform(a, b):
            return a

    d = net.backoff_delays(7, rng=Lo)
    assert d == [C.SEND_BACKOFF_BASE * 2 ** k * (1 - C.SEND_JITTER_FRACTION)
                 if C.SEND_BACKOFF_BASE * 2 ** k < C.SEND_BACKOFF_CAP
                 else C.SEND_BACKOFF_CAP * (1 - C.SEND_JITTER_FRACTION)
                 for k in range(6)]


@pytest.fixture
def port_server(tmp_path):
    st = ServerState(config_path=str(tmp_path / "cfg.json"), device="cpu",
                     input_dir=str(tmp_path), output_dir=str(tmp_path),
                     start_exec_thread=False)
    srv = make_server(st, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield st, f"http://127.0.0.1:{st.port}"
    srv.shutdown()
    srv.server_close()


def test_negotiation(port_server, flaky):
    _, url = port_server
    net.reset_wire_cache()
    assert net.negotiate_wire_format(url) == C.TENSOR_WIRE_CONTENT_TYPE
    assert net.wire_codec(url) == "zlib"
    # a peer without the route (404 on GET) gets PNG
    assert net.negotiate_wire_format(flaky) == "image/png"
    net.reset_wire_cache()


def test_aiohttp_client_form_reaches_the_port_server(port_server):
    """The JAX package's sender (aiohttp's client and FormData) against
    the port's route: the tile lands in its queue once, and a retried
    upload with the same idempotency key is acknowledged, not queued."""
    import aiohttp
    st, url = port_server
    st.jobs.prepare_tile_job("exec_1_2")
    tile = _img((1, 10, 12, 3))

    async def send(mj):
        fd = aiohttp.FormData()
        for k, v in (("multi_job_id", mj), ("worker_id", "w0"),
                     ("tile_idx", "5"), ("x", "8"), ("y", "0"),
                     ("extracted_width", "12"), ("extracted_height", "10"),
                     ("padding", "4"), ("idem_key", "w0:5:0"),
                     ("is_last", "true")):
            fd.add_field(k, v)
        fd.add_field("tile", jimg.encode_tensor(tile, "zlib"),
                     filename="tile_5.dtt",
                     content_type=C.TENSOR_WIRE_CONTENT_TYPE)
        async with aiohttp.ClientSession() as s:
            async with s.post(url + "/distributed/tile_complete",
                              data=fd) as r:
                return r.status

    assert asyncio.run(send("exec_1_2")) == 200
    assert asyncio.run(send("exec_1_2")) == 200
    assert asyncio.run(send("unknown")) == 404
    q = st.jobs.get_tile_queue("exec_1_2")
    assert q.qsize() == 1
    item = q.get()
    assert {k: item[k] for k in ("tile_idx", "x", "y", "extracted_width",
                                 "extracted_height", "padding", "is_last",
                                 "worker_id")} == {
        "tile_idx": 5, "x": 8, "y": 0, "extracted_width": 12,
        "extracted_height": 10, "padding": 4, "is_last": True,
        "worker_id": "w0"}
    np.testing.assert_array_equal(item["tensor"], tile)
    m = net.get_json(url + "/distributed/metrics")
    # as the JAX package counts: every acknowledged POST, a replay too
    assert m["tiles_received"] == 2 and m["wire_tensor_msgs"] == 3


def test_routes_and_status_codes(port_server, tmp_path):
    st, url = port_server
    assert net.get_json(url + "/prompt") == {"exec_info":
                                             {"queue_remaining": 0}}
    assert net.get_json(url + "/distributed/wire_formats") == {
        "formats": [C.TENSOR_WIRE_CONTENT_TYPE, "image/png"],
        "tensor_codecs": ["zlib"]}
    assert net.post_json(url + "/distributed/prepare_job",
                         {"multi_job_id": "j", "kind": "tile"}) \
        == {"status": "ok"}
    assert net.get_json(url + "/distributed/queue_status?multi_job_id=j") \
        == {"exists": True, "queue_remaining": 0}
    with pytest.raises(RuntimeError, match="400"):
        net.post_json(url + "/distributed/prepare_job", {})
    w = net.post_json(url + "/distributed/config/update_worker",
                      {"id": "w0", "port": 1, "enabled": True})
    assert w == {"status": "ok", "worker": {"id": "w0", "port": 1,
                                            "enabled": True}}
    assert net.get_json(url + "/distributed/config")["workers"] \
        == [w["worker"]]
    assert net.post_json(url + "/distributed/config/delete_worker",
                         {"id": "w0"}) == {"status": "ok"}
    with pytest.raises(RuntimeError, match="404"):
        net.post_json(url + "/distributed/config/delete_worker",
                      {"id": "w0"})
    with pytest.raises(RuntimeError, match="404"):
        net.post_json(url + "/distributed/load_image",
                      {"image_name": "none.png"})
    with pytest.raises(RuntimeError, match="400"):
        net.post_json(url + "/distributed/load_image",
                      {"image_name": "../../etc/passwd"})
    # upload, then load back: the staging round trip
    form = net.FormData()
    png = encode_png(_img()[0])
    form.add_field("image", png, filename="a.png", content_type="image/png")
    import urllib.request
    req = urllib.request.Request(url + "/upload/image", data=form.encode(),
                                 headers={"Content-Type": form.content_type})
    with urllib.request.urlopen(req, timeout=10) as r:
        assert json.loads(r.read()) == {"name": "a.png", "subfolder": "",
                                        "type": "input"}
    import base64
    got = net.post_json(url + "/distributed/load_image",
                        {"image_name": "a.png"})
    assert base64.b64decode(got["image_data"]) == png
    assert net.get_json(url + "/history") == {}
    assert set(net.get_json(url + "/distributed/metrics")) >= {
        "prompts_executed", "prompts_failed", "images_received",
        "tiles_received"}
