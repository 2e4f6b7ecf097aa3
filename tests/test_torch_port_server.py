"""The port's fan-out pieces in one process: the collector's master and
worker halves against an in-thread server, the tiled upscaler's wire
form of a tile, SaveImage, input staging and the CLI's device rule."""

import base64
import collections
import json
import os
import pathlib
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu_torch.ops import tiling
from comfyui_distributed_tpu_torch.ops.base import DeviceImage, OpContext
from comfyui_distributed_tpu_torch.ops.basic import SaveImage
from comfyui_distributed_tpu_torch.ops.distributed import DistributedCollector
from comfyui_distributed_tpu_torch.ops.tiled_upscale import (
    UltimateSDUpscaleDistributed)
from comfyui_distributed_tpu_torch.runtime.jobs import JobStore
from comfyui_distributed_tpu_torch.server.app import ServerState, make_server
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils import net
from comfyui_distributed_tpu_torch.utils.image import decode_png, save_png
from comfyui_distributed_tpu_torch.workflow import orchestrate as orch
from comfyui_distributed_tpu_torch.workflow.orchestrate import (
    stage_images_on_worker)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _img(b=1, h=6, w=5, seed=0):
    return np.random.default_rng(seed).uniform(
        size=(b, h, w, 3)).astype(np.float32)


@pytest.fixture
def server(tmp_path):
    """A server with no execution thread, serving in a thread."""
    made = []

    def make(name="m"):
        d = tmp_path / name
        st = ServerState(config_path=str(d / "cfg.json"), device="cpu",
                         input_dir=str(d / "input"),
                         output_dir=str(d / "output"),
                         start_exec_thread=False)
        srv = make_server(st, "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        made.append(srv)
        return st, f"http://127.0.0.1:{st.port}"

    yield make
    for srv in made:
        srv.shutdown()
        srv.server_close()


def test_collector_worker_to_master_orders_master_first(server):
    """Two workers' images through the real route; the master's drain
    orders master first, then worker_0, then worker_1, each by its
    image_index, whatever the arrival order."""
    st, url = server()
    st.jobs.prepare_job("exec_1_14")
    imgs = {w: _img(2, seed=i + 1) for i, w in enumerate(("worker_0",
                                                          "worker_1"))}
    net.reset_wire_cache()
    for wid in ("worker_1", "worker_0"):
        DistributedCollector().execute(
            OpContext(device="cpu"), DeviceImage(torch.from_numpy(imgs[wid])),
            multi_job_id="exec_1_14", is_worker=True, master_url=url,
            worker_id=wid)
    master = _img(1, seed=0)
    ctx = OpContext(device="cpu", job_store=st.jobs)
    (out,) = DistributedCollector().execute(
        ctx, DeviceImage(torch.from_numpy(master)),
        multi_job_id="exec_1_14", enabled_worker_ids='["w0", "w1"]')
    np.testing.assert_array_equal(out.data.numpy(), np.concatenate(
        [master, imgs["worker_0"], imgs["worker_1"]]))
    assert st.metrics["images_received"] == 4
    assert not st.jobs.has_job("exec_1_14")   # late arrivals now 404


def test_collector_keeps_the_partial_batch_on_a_deadline(monkeypatch):
    monkeypatch.setattr(C, "WORKER_JOB_TIMEOUT", 0.2)
    store = JobStore()
    store.prepare_job("j")
    late = _img(1, seed=3)
    # worker_0 sends one image but not its last; worker_1 nothing
    store.put_result("j", {"worker_id": "worker_0", "image_index": 0,
                           "is_last": False, "tensor": late})
    master = _img(1, seed=0)
    (out,) = DistributedCollector().execute(
        OpContext(device="cpu", job_store=store),
        DeviceImage(torch.from_numpy(master)), multi_job_id="j",
        enabled_worker_ids='["w0", "w1"]')
    np.testing.assert_array_equal(out.data.numpy(),
                                  np.concatenate([master, late]))


def test_collector_dedupes_a_replayed_image_and_passes_through():
    store = JobStore()
    store.prepare_job("j")
    a, b = _img(1, seed=1), _img(1, seed=2)
    for t, last in ((a, False), (b, True)):   # index 0 sent again
        store.put_result("j", {"worker_id": "worker_0", "image_index": 0,
                               "is_last": last, "tensor": t})
    master = DeviceImage(torch.from_numpy(_img(1)))
    (out,) = DistributedCollector().execute(
        OpContext(device="cpu", job_store=store), master, multi_job_id="j",
        enabled_worker_ids='["w0"]')
    assert out.shape == (2, 6, 5, 3)   # overwritten, not added
    np.testing.assert_array_equal(out.data.numpy()[1], b[0])
    assert DistributedCollector().execute(
        OpContext(device="cpu"), master, pass_through=True) == (master,)


@pytest.mark.parametrize("pos", [(0, 0), (32, 0), (32, 32)])
def test_tile_wire_form_round_trips(pos):
    """The worker cuts a refined window to its clamped extraction region;
    the master re-inflates it to the window; the blend cuts the same
    region: the tile that is blended is the tile that was sent."""
    op = UltimateSDUpscaleDistributed()
    p = dict(tile_w=32, tile_h=32, padding=8, mask_blur=2)
    window = torch.rand(48, 48, 3)
    tile, (x1, y1, x2, y2) = op._window_to_extracted(window, pos, p, (64, 64))
    assert tile.shape == (y2 - y1, x2 - x1, 3)
    assert (x1, y1, x2, y2) == tiling.extraction_region(*pos, 32, 32, 8,
                                                        64, 64)
    back = op._worker_tile_to_window({"tensor": tile[None].numpy()}, pos, p,
                                     (64, 64), torch.device("cpu"))
    assert back.shape == (48, 48, 3)
    again, _ = op._window_to_extracted(back, pos, p, (64, 64))
    torch.testing.assert_close(again, tile, rtol=0, atol=0)


def test_tiles_reach_the_master_queue_in_wire_form(server):
    st, url = server()
    st.jobs.prepare_tile_job("exec_1_2")
    op = UltimateSDUpscaleDistributed()
    p = dict(tile_w=32, tile_h=32, padding=8, mask_blur=2)
    all_tiles = tiling.calculate_tiles(64, 64, 32, 32)
    windows = {i: torch.rand(48, 48, 3) for i in (2, 3)}
    net.reset_wire_cache()
    op._send_tiles(windows, [2, 3], all_tiles, p, "exec_1_2", url, "w0",
                   (64, 64))
    got = op._collect_tiles(OpContext(device="cpu", job_store=st.jobs),
                            "exec_1_2", 1)
    assert sorted(got) == [2, 3]
    for i in (2, 3):
        want, (x1, y1, x2, y2) = op._window_to_extracted(
            windows[i], all_tiles[i], p, (64, 64))
        item = got[i]
        assert (item["x"], item["y"], item["extracted_width"],
                item["extracted_height"], item["padding"]) == \
            (x1, y1, x2 - x1, y2 - y1, 8)
        np.testing.assert_array_equal(item["tensor"][0], want.numpy())
    assert got[3]["is_last"] and not got[2]["is_last"]
    assert st.metrics["tiles_received"] == 2


def test_worker_outside_the_enabled_list_does_nothing():
    op = UltimateSDUpscaleDistributed()
    op._run_worker(OpContext(device="cpu"), torch.zeros(1, 64, 64, 3), None,
                   None, None, dict(tile_w=32, tile_h=32, padding=8),
                   "j", "http://127.0.0.1:9", "w9", '["w0"]')


def test_save_image_counters_continue_and_store_the_prompt(tmp_path):
    ctx = OpContext(device="cpu", output_dir=str(tmp_path),
                    prompt_json={"9": {"class_type": "SaveImage"}})
    (tmp_path / "pre_00007.png").write_bytes(b"")   # another prefix
    imgs = _img(2)
    SaveImage().execute(ctx, DeviceImage(torch.from_numpy(imgs)))
    SaveImage().execute(ctx, imgs[:1])
    names = sorted(p.name for p in tmp_path.glob("DistributedTPU_*.png"))
    assert names == [f"DistributedTPU_{i:05d}.png" for i in range(3)]
    data = (tmp_path / "DistributedTPU_00001.png").read_bytes()
    import io

    from PIL import Image
    assert json.loads(Image.open(io.BytesIO(data)).text["prompt"]) \
        == ctx.prompt_json
    np.testing.assert_allclose(decode_png(data)[0], imgs[1], atol=0.5 / 255)
    assert len(ctx.saved_images) == 3
    SaveImage().execute(ctx, imgs, filename_prefix="sub/x")
    assert (tmp_path / "sub" / "x_00001.png").exists()
    with pytest.raises(ValueError, match="escapes"):
        SaveImage().execute(ctx, imgs, filename_prefix="../out")


def test_stage_images_on_worker(server, tmp_path):
    master, murl = server("m")
    worker, wurl = server("w")
    (tmp_path / "m" / "input").mkdir(parents=True)
    save_png(str(tmp_path / "m" / "input" / "in.png"), _img()[0])
    stage_images_on_worker(murl, {"id": "w", "host": "127.0.0.1",
                                  "port": worker.port},
                           ["in.png [input]", "missing.png"])
    assert (tmp_path / "w" / "input" / "in.png").read_bytes() == \
        (tmp_path / "m" / "input" / "in.png").read_bytes()
    assert not (tmp_path / "w" / "input" / "missing.png").exists()


def _fake(host, handlers):
    """An HTTP server on ``host`` answering ``handlers[(method, path)]
    (body) -> (status, JSON)`` and counting its hits; returns (server,
    port, hits)."""
    hits = collections.Counter()

    class Handler(BaseHTTPRequestHandler):
        def _do(self, method):
            body = self.rfile.read(int(self.headers.get("Content-Length")
                                       or 0))
            hits[(method, self.path)] += 1
            status, payload = handlers.get((method, self.path),
                                           lambda b: (404, {}))(body)
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            self._do("GET")

        def do_POST(self):
            self._do("POST")

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer((host, 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, srv.server_address[1], hits


def _master_with_image():
    def load_image(body):
        time.sleep(0.2)       # both stagers arrive while the read is out
        return 200, {"image_data": base64.b64encode(b"png").decode()}
    return _fake("127.0.0.1", {("POST", "/distributed/load_image"):
                               load_image})


def _remote_worker(upload_status):
    """A worker on another loopback address, so the orchestrator takes
    it for a remote host and stages input images on it."""
    return _fake("127.0.0.2", {
        ("GET", "/prompt"): lambda b: (200, {"exec_info": {}}),
        ("POST", "/prompt"): lambda b: (200, {"prompt_id": "p"}),
        ("POST", "/upload/image"): lambda b: (upload_status, {})})


def _upscale_doc():
    return json.loads((ROOT / "workflows" / "distributed-upscale.json")
                      .read_text())


def test_staging_reads_each_image_once_for_two_remote_workers():
    """Staging happens before any dispatch, on every remote worker at
    once, and the master is read once per image for all of them."""
    master, mport, mhits = _master_with_image()
    workers = [_remote_worker(200) for _ in range(2)]
    calls = []
    try:
        out = orch.run_distributed(
            _upscale_doc(), f"http://127.0.0.1:{mport}",
            lambda g: calls.append(g) or "master-result",
            [{"id": f"w{i}", "host": "127.0.0.2", "port": port}
             for i, (_, port, _) in enumerate(workers)],
            job_store=JobStore())
    finally:
        for srv in [master] + [w[0] for w in workers]:
            srv.shutdown()
            srv.server_close()
    assert out["result"] == "master-result" and len(calls) == 1
    assert out["workers"] == ["w0", "w1"] and out["failed"] == []
    assert mhits[("POST", "/distributed/load_image")] == 1
    for _, _, hits in workers:
        assert hits[("POST", "/upload/image")] == 1
        assert hits[("POST", "/prompt")] == 1


def test_failed_staging_fails_the_request_before_anything_is_queued():
    master, mport, _ = _master_with_image()
    good, bad = _remote_worker(200), _remote_worker(500)
    store, calls = JobStore(), []
    try:
        with pytest.raises(RuntimeError, match="image staging to w1"):
            orch.run_distributed(
                _upscale_doc(), f"http://127.0.0.1:{mport}", calls.append,
                [{"id": "w0", "host": "127.0.0.2", "port": good[1]},
                 {"id": "w1", "host": "127.0.0.2", "port": bad[1]}],
                job_store=store)
    finally:
        for srv in (master, good[0], bad[0]):
            srv.shutdown()
            srv.server_close()
    assert calls == []
    assert store.snapshot() == {"image_jobs": [], "tile_jobs": []}
    assert good[2][("POST", "/prompt")] == bad[2][("POST", "/prompt")] == 0


def test_cli_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    proc = subprocess.run(
        [sys.executable, "-m", "comfyui_distributed_tpu_torch.cli", "worker",
         "--host", "127.0.0.1", "--port", str(net.find_free_port()),
         "--config", str(tmp_path / "cfg.json")],
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is false" in proc.stderr
