"""The port's reuse plane (``runtime/reuse.py``), its three tiers in the
server, the executor, the ops and the tiled upscale, the preview route
and the surfaces that read them, on the CPU.

- ``hash_array`` and the byte LRU against the JAX package's on
  numpy-seeded inputs;
- the exact-hit tier: a byte-identical re-submission is replayed
  (``cache_hit``), equal to the bit to a recompute; a one-widget change
  never hits;
- the encode tier: a new seed on the same text takes the memoised
  conditionings (the node spans say ``cache_hit``), and its image equals
  a ``DTPU_CACHE=0`` run's to the bit;
- the tile tier: a re-run skips every tile and equals the first to the
  bit; a changed source refines exactly the tiles whose windows changed,
  and equals a ``DTPU_CACHE=0`` run of it to the bit outside them;
- ``DTPU_CACHE=0`` computes no key and makes no lookup;
- ``clear_memory`` reports the freed cache bytes;
- the preview route: the terminal event, the purge of an abandoned
  queued prompt, and the JAX package's 403, 404 and 429;
- the ``reuse`` metrics block, the ``dtpu_cache_*``/``dtpu_preview_*``
  families, ``cli reuse``, ``cache_bytes`` and ``/distributed/warmup``."""

import contextlib
import copy
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.runtime import reuse as jreuse
from comfyui_distributed_tpu_torch import cli
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.ops import tiling
from comfyui_distributed_tpu_torch.ops import tiled_upscale as tup
from comfyui_distributed_tpu_torch.ops.base import OpContext
from comfyui_distributed_tpu_torch.runtime import reuse
from comfyui_distributed_tpu_torch.server.app import (
    ServerState,
    make_server,
    routes,
)
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils import resource
from comfyui_distributed_tpu_torch.utils import trace as trace_mod
from comfyui_distributed_tpu_torch.utils.image import save_png
from comfyui_distributed_tpu_torch.workflow.executor import WorkflowExecutor

from test_torch_port_coalesce import make_prompt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERIAL_ATOL = 2e-4


@pytest.fixture(autouse=True)
def tiny_and_fresh(monkeypatch):
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny")
    monkeypatch.delenv(C.CACHE_ENV, raising=False)
    monkeypatch.delenv(C.PREVIEW_ENV, raising=False)
    reuse.reset_reuse()
    jreuse.reset_reuse()
    yield
    treg.clear_pipeline_cache()
    reuse.reset_reuse()
    jreuse.reset_reuse()


@pytest.fixture
def server(tmp_path):
    """Port servers on loopback sockets."""
    made = []

    def make(name="m", **kw):
        d = tmp_path / name
        st = ServerState(config_path=str(d / "cfg.json"), device="cpu",
                         input_dir=str(d / "in"), output_dir=str(d / "out"),
                         **kw)
        srv = make_server(st, "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        made.append((st, srv))
        return st, f"http://127.0.0.1:{st.port}"

    yield make
    for st, srv in made:
        st.drain(10)
        srv.shutdown()
        srv.server_close()


def wait_history(st, pids, timeout=120):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(p in st._history for p in pids):
            return {p: st._history[p] for p in pids}
        time.sleep(0.01)
    raise AssertionError(f"never finished: {pids}")


def cache_counters():
    return {k: v for k, v in trace_mod.GLOBAL_COUNTERS.snapshot().items()
            if k.startswith("cache_") or k == "tiles_skipped"}


def inline_images(prompt, **ctx):
    res = WorkflowExecutor(OpContext(device="cpu", **ctx)).execute(
        copy.deepcopy(prompt))
    return res.images


# --- keys and the LRU ---------------------------------------------------------

def test_hash_array_equals_the_jax_packages():
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3)).astype(np.float32)
    assert reuse.hash_array(torch.from_numpy(x)) == jreuse.hash_array(x)
    assert reuse.hash_array(x) == jreuse.hash_array(x)
    u8 = rng.integers(0, 255, (4, 4), dtype=np.uint8)
    assert reuse.hash_array(torch.from_numpy(u8)) == jreuse.hash_array(u8)
    bf = torch.from_numpy(x).to(torch.bfloat16)
    assert reuse.hash_array(bf) == jreuse.hash_array(
        np.asarray(jnp.asarray(bf.float().numpy(), jnp.bfloat16)))
    assert reuse.hash_array(x[:, :4]) != reuse.hash_array(x[:, :4] + 1e-6)


def test_lru_evicts_by_bytes_as_the_jax_packages_does():
    """A scripted sequence of puts and gets from a numpy seed: the same
    hits, evictions, residency and survivors in both packages."""
    rng = np.random.default_rng(7)
    ours = reuse.ByteLRU("t", max_bytes=1000, max_entries=6)
    theirs = jreuse.ByteLRU("t", max_bytes=1000, max_entries=6)
    for _ in range(400):
        key = f"k{rng.integers(0, 12)}"
        if rng.uniform() < 0.5:
            nb = int(rng.integers(50, 420))
            assert ours.put(key, nb, nb) == theirs.put(key, nb, nb)
        else:
            assert ours.get(key) == theirs.get(key)
        assert ours.bytes == theirs.bytes <= 1000
    assert ours.snapshot() == theirs.snapshot()
    assert ours.keys() == theirs.keys()
    assert ours.snapshot()["evictions"] > 0
    # one value over the whole budget is refused, not stored
    assert not ours.put("big", 1, 1001) and "big" not in ours.keys()
    assert ours.clear() == theirs.clear() and ours.bytes == 0


def test_plane_snapshot_and_budgets_match_the_jax_package(monkeypatch):
    monkeypatch.setenv(C.CACHE_DEVICE_BYTES_ENV, "12345")
    ours, theirs = reuse.reset_reuse(), jreuse.reset_reuse()
    assert ours.snapshot() == theirs.snapshot()
    assert ours.subgraph.max_bytes == 12345
    assert reuse.PREVIEWS.snapshot().keys() \
        == jreuse.PREVIEWS.snapshot().keys()
    # the memo's bytes count the context and the pooled vector
    cond = type("Cond", (), {"context": torch.zeros(1, 77, 8),
                             "pooled": torch.zeros(1, 16,
                                                   dtype=torch.bfloat16)})
    assert reuse.conditioning_nbytes(cond) == 77 * 8 * 4 + 16 * 2


def test_preview_bus_and_frames_match_the_jax_package(monkeypatch):
    """The bus's events, cap and abandonment flags, and a latent's
    preview frame (decoded: the two packages' PNG writers differ in
    their bytes, not their pixels), against the JAX package's."""
    from comfyui_distributed_tpu.utils.image import decode_png as jdecode
    from comfyui_distributed_tpu_torch.utils.image import decode_png
    lat = np.random.default_rng(11).standard_normal(
        (1, 8, 6, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        decode_png(reuse.latent_preview_png(torch.from_numpy(lat))),
        jdecode(jreuse.latent_preview_png(lat)))
    monkeypatch.setenv(C.PREVIEW_EVERY_ENV, "3")
    assert reuse.preview_every() == jreuse.preview_every() == 3
    got = []
    for mod in (reuse, jreuse):
        bus = mod.PreviewBus(max_clients=2)
        q1, q2 = bus.subscribe("p"), bus.subscribe("p")
        assert bus.subscribe("q") is None and bus.wants("p")
        bus.publish_latent("p", 1, 4, lat)
        bus.abandon("p")
        assert bus.is_abandoned("p")
        assert bus.unsubscribe("p", q1) == 1
        bus.finish("p", "abandoned")
        assert not bus.is_abandoned("p")
        events = [q2.get_nowait() for _ in range(2)]
        assert q1.get_nowait()["type"] == "preview"
        for ev in events:
            ev.pop("png_b64", None)
        got.append((events, bus.snapshot()))
    assert got[0] == got[1]


# --- the exact-hit tier -------------------------------------------------------

def test_replay_is_the_recompute_to_the_bit(server):
    st, url = server()
    prompt = make_prompt(5)
    first = st.enqueue_prompt(copy.deepcopy(prompt))
    wait_history(st, [first])
    runs0 = trace_mod.GLOBAL_COUNTERS.get("exec_runs")
    second = st.enqueue_prompt(copy.deepcopy(prompt))
    h = wait_history(st, [second])[second]
    assert h["cache_hit"] is True and h["status"] == "success"
    assert h["images"] == 1 and h["duration_s"] == 0.0
    assert trace_mod.GLOBAL_COUNTERS.get("exec_runs") == runs0
    assert st.metrics["prompts_replayed"] == 1
    key = reuse.result_key(prompt, st.input_dir, st.models_dir)
    entry = reuse.get_reuse().result.get(key)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(C.CACHE_ENV, "0")
        recompute = inline_images(prompt)
    np.testing.assert_array_equal(entry["images"][0], recompute[0])
    rec = trace_mod.GLOBAL_TRACES.get(second)
    root = next(s for s in rec["spans"] if s["name"] == "job")
    assert root["attrs"]["cache_hit"] is True
    assert root["attrs"]["cache_tier"] == "result"
    # a near miss (one widget) runs
    near = copy.deepcopy(prompt)
    near["8"]["inputs"]["cfg"] = 2.5
    third = st.enqueue_prompt(near)
    assert "cache_hit" not in wait_history(st, [third])[third]
    assert trace_mod.GLOBAL_COUNTERS.get("exec_runs") == runs0 + 1
    # a SaveImage graph is never replayed
    save = make_prompt(5, output="SaveImage")
    pids = [st.enqueue_prompt(copy.deepcopy(save)) for _ in range(2)]
    assert all("cache_hit" not in h
               for h in wait_history(st, pids).values())
    assert len(os.listdir(st.output_dir)) == 2


def test_encode_tier_skips_the_text_encoder(server, monkeypatch):
    """A new seed on the same text: the text encodes come from the memo
    (each CLIPTextEncode span says so), the image equals a
    ``DTPU_CACHE=0`` run's to the bit."""
    st, _ = server()
    wait_history(st, [st.enqueue_prompt(make_prompt(1))])
    calls = []
    real = treg.DiffusionPipeline.encode_prompt

    def spy(self, *a, **kw):
        calls.append(a)
        return real(self, *a, **kw)

    monkeypatch.setattr(treg.DiffusionPipeline, "encode_prompt", spy)
    pid = st.enqueue_prompt(make_prompt(2))
    wait_history(st, [pid])
    assert calls == []
    rec = trace_mod.GLOBAL_TRACES.get(pid)
    enc = [s for s in rec["spans"] if s["name"] == "CLIPTextEncode"]
    assert len(enc) == 2
    assert all(s["attrs"].get("cache_hit") is True
               and s["attrs"].get("cache_tier") == "embed" for s in enc)
    key = reuse.result_key(make_prompt(2), st.input_dir, st.models_dir)
    got = reuse.get_reuse().result.get(key)["images"][0]
    monkeypatch.setenv(C.CACHE_ENV, "0")
    np.testing.assert_array_equal(got, inline_images(make_prompt(2))[0])
    assert len(calls) == 2


def test_cache_off_computes_no_key_and_makes_no_lookup(server, monkeypatch):
    monkeypatch.setenv(C.CACHE_ENV, "0")

    def refuse(*a, **kw):
        raise AssertionError("a key was computed")

    for name in ("result_key", "subgraph_keys", "tile_keys"):
        monkeypatch.setattr(reuse, name, refuse)
    before = cache_counters()
    st, _ = server()
    pids = [st.enqueue_prompt(make_prompt(3)) for _ in range(2)]
    hist = wait_history(st, pids)
    assert all(h["status"] == "success" and "cache_hit" not in h
               for h in hist.values())
    assert cache_counters() == before
    assert reuse.get_reuse().bytes_total() == 0
    assert resource.fleet_sample("cpu")["cache_bytes"] == 0


def test_clear_memory_reports_the_freed_cache_bytes(server):
    st, _ = server()
    wait_history(st, [st.enqueue_prompt(make_prompt(4))])
    plane = reuse.get_reuse()
    held = plane.bytes_total()
    assert held > 0 and plane.subgraph.bytes > 0 and plane.result.bytes > 0
    assert resource.fleet_sample("cpu")["cache_bytes"] == held
    table = routes(st)
    status, body = table[("POST", "/distributed/clear_memory")](
        b"{}", "application/json", {})
    assert status == 200 and body["cache_freed_bytes"] == held
    assert plane.bytes_total() == 0 and plane.snapshot()["generation"] == 1


# --- the tile tier ------------------------------------------------------------

def _upscale_doc(tmp_path, px):
    """The upscale workflow at a small size: a 64^2 input, 2x tiny RRDB,
    ImageScale to 128^2, sixteen 32^2 tiles + 8 px, 2 steps."""
    save_png(str(tmp_path / "input.png"), px)
    with open(os.path.join(ROOT, "workflows", "distributed-upscale.json"),
              "r", encoding="utf-8") as f:
        doc = json.load(f)
    doc["16"]["inputs"].update(width=128, height=128)
    doc["2"]["inputs"].update(steps=2, tile_width=32, tile_height=32,
                              padding=8, mask_blur=2)
    return doc


def test_tile_tier_refines_only_the_changed_tiles(tmp_path, monkeypatch):
    refined = []
    real = tup.UltimateSDUpscaleDistributed._refine_tiles

    def spy(self, ctx, pipe, image, all_tiles, indices, *a, **kw):
        refined.append(list(indices))
        return real(self, ctx, pipe, image, all_tiles, indices, *a, **kw)

    monkeypatch.setattr(tup.UltimateSDUpscaleDistributed, "_refine_tiles",
                        spy)
    rng = np.random.default_rng(8)
    px = rng.uniform(size=(64, 64, 3)).astype(np.float32)
    doc = _upscale_doc(tmp_path, px)

    def run():
        return WorkflowExecutor(OpContext(
            device="cpu", input_dir=str(tmp_path))).execute(
            copy.deepcopy(doc))

    first = run()
    assert refined == [list(range(16))]
    skipped0 = trace_mod.GLOBAL_COUNTERS.get("tiles_skipped")
    again = run()
    assert trace_mod.GLOBAL_COUNTERS.get("tiles_skipped") - skipped0 == 16
    assert refined[1:] == []
    np.testing.assert_array_equal(first.image_batch, again.image_batch)
    # one small patch of the source changes
    px2 = px.copy()
    px2[4:8, 4:8] = 0.9
    save_png(str(tmp_path / "input.png"), px2)
    changed = run()
    p = {"tile_w": 32, "tile_h": 32, "padding": 8}
    tiles = tiling.calculate_tiles(128, 128, 32, 32)
    win_a = tiling.extract_tiles(first.outputs["16"][0].data, tiles,
                                 32, 32, 8)
    win_b = tiling.extract_tiles(changed.outputs["16"][0].data, tiles,
                                 32, 32, 8)
    dirty = [i for i in range(16) if not torch.equal(win_a[i], win_b[i])]
    assert 0 < len(dirty) < 16
    assert refined[1:] == [dirty]
    monkeypatch.setenv(C.CACHE_ENV, "0")
    fresh = run().image_batch
    got = changed.image_batch
    # the clean tiles' pixels are the fresh run's to the bit; the dirty
    # ones were refined in a smaller batch
    outside = np.ones(got.shape[1:3], bool)
    for i in dirty:
        x1, y1, x2, y2 = tiling.extraction_region(
            *tiles[i], p["tile_w"], p["tile_h"], p["padding"], 128, 128)
        outside[y1:y2, x1:x2] = False
    assert outside.any()
    np.testing.assert_array_equal(got[0][outside], fresh[0][outside])
    np.testing.assert_allclose(got, fresh, rtol=0, atol=SERIAL_ATOL)


# --- previews -----------------------------------------------------------------

def read_sse(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        events = []
        for block in r.read().decode().split("\n\n"):
            lines = dict(ln.split(": ", 1) for ln in block.splitlines()
                         if ln and not ln.startswith(":"))
            if "event" in lines:
                events.append((lines["event"], json.loads(lines["data"])))
        return events


def http_error(url):
    try:
        urllib.request.urlopen(url, timeout=10).read()
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    raise AssertionError("no error")


def test_preview_stream_ends_with_the_terminal_event(server):
    st, url = server()
    pid = st.enqueue_prompt(make_prompt(6))
    events = read_sse(f"{url}/distributed/preview/{pid}")
    kind, ev = events[-1]
    assert kind == "done" and ev["type"] == "done"
    assert ev["prompt_id"] == pid
    # the bus's event while attached (the finalize's "ok"), else the
    # history's status, as in the JAX package
    assert ev["status"] in ("ok", "success")
    assert reuse.PREVIEWS.client_count() == 0
    # a finished prompt's stream is that one event
    assert read_sse(f"{url}/distributed/preview/{pid}") == [
        ("done", {"type": "done", "prompt_id": pid, "status": "success"})]


def test_preview_refusals_have_the_jax_packages_bodies(server, monkeypatch):
    st, url = server()
    assert http_error(f"{url}/distributed/preview/nope") == (404, {
        "error": "unknown prompt 'nope' (not queued, not executing, not "
                 "in history)"})
    monkeypatch.setenv(C.PREVIEW_ENV, "0")
    assert http_error(f"{url}/distributed/preview/nope") == (403, {
        "error": "previews disabled (DTPU_PREVIEW=0)"})
    monkeypatch.setenv(C.PREVIEW_ENV, "1")
    monkeypatch.setenv(C.PREVIEW_MAX_CLIENTS_ENV, "1")
    pid = st.enqueue_prompt(make_prompt(7))
    wait_history(st, [pid])
    q = reuse.PREVIEWS.subscribe(pid)
    try:
        assert http_error(f"{url}/distributed/preview/{pid}") == (429, {
            "error": "too many preview clients"})
    finally:
        reuse.PREVIEWS.unsubscribe(pid, q)


def test_a_queued_prompt_whose_client_leaves_is_purged(server):
    """The last client of a queued prompt disconnects: the prompt is
    finalized ``abandoned`` before it ever runs, and counted."""
    st, url = server()
    release, runs = threading.Event(), []
    real = st._execute

    def execute(item):
        runs.append(item["id"])
        if len(runs) == 1:
            release.wait(30)
        real(item)

    st._execute = execute
    blocker = st.enqueue_prompt({"1": {"class_type": "EmptyLatentImage",
                                       "inputs": {"width": 8, "height": 8,
                                                  "batch_size": 1}}})
    deadline = time.monotonic() + 10
    while runs != [blocker]:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    queued = st.enqueue_prompt(make_prompt(8))
    with contextlib.closing(socket.create_connection(
            ("127.0.0.1", st.port), timeout=10)) as sock:
        sock.sendall(f"GET /distributed/preview/{queued} HTTP/1.1\r\n"
                     f"Host: x\r\n\r\n".encode())
        head = sock.recv(4096)
        assert head.startswith(b"HTTP/1.0 200") \
            or head.startswith(b"HTTP/1.1 200")
    deadline = time.monotonic() + 15
    while not reuse.PREVIEWS.is_abandoned(queued):
        assert time.monotonic() < deadline
        time.sleep(0.05)
    release.set()
    h = wait_history(st, [queued])[queued]
    assert h["status"] == "abandoned"
    assert "client disconnected" in h["error"]
    assert queued not in runs
    assert st.metrics["prompts_abandoned"] == 1
    assert not reuse.PREVIEWS.is_abandoned(queued)
    prom = urllib.request.urlopen(
        f"{url}/distributed/metrics.prom", timeout=10).read().decode()
    assert "dtpu_jobs_abandoned_total 1" in prom


# --- the surfaces -------------------------------------------------------------

def test_metrics_prometheus_cli_and_warmup(server, capsys):
    st, url = server()
    prompt = make_prompt(9)
    wait_history(st, [st.enqueue_prompt(copy.deepcopy(prompt))])
    wait_history(st, [st.enqueue_prompt(copy.deepcopy(prompt))])
    with urllib.request.urlopen(f"{url}/distributed/metrics",
                                timeout=10) as r:
        m = json.loads(r.read())
    assert m["pipeline"]["overlap"] is True
    assert m["pipeline"]["coalesce"] is True
    assert set(m["reuse"]) == set(jreuse.ReusePlane().snapshot()) \
        | {"previews"}
    assert set(m["reuse"]["previews"]) == set(jreuse.PREVIEWS.snapshot())
    assert m["reuse"]["result"]["hits"] == 1
    assert m["reuse"]["embed"]["entries"] == 2
    assert m["prompts_replayed"] == 1
    prom = urllib.request.urlopen(
        f"{url}/distributed/metrics.prom", timeout=10).read().decode()
    for family in ("dtpu_cache_hits_total", "dtpu_cache_misses_total",
                   "dtpu_cache_evictions_total", "dtpu_cache_bytes",
                   "dtpu_cache_replays_total",
                   "dtpu_cache_tiles_skipped_total", "dtpu_preview_clients",
                   "dtpu_preview_events_total",
                   "dtpu_jobs_abandoned_total"):
        assert f"# TYPE {family} " in prom
    assert 'dtpu_cache_hits_total{tier="result"} 1' in prom
    assert "dtpu_cache_replays_total 1" in prom
    assert cli.main(["reuse", "--url", url]) == 0
    out = capsys.readouterr().out
    assert "reuse plane: enabled=True" in out
    assert all(f"\n{t} " in out for t in ("result", "embed", "tile"))
    assert "replays=1" in out
    req = urllib.request.Request(
        f"{url}/distributed/warmup", method="POST",
        data=json.dumps({"ckpt_name": "tiny.safetensors", "width": 32,
                         "height": 32, "steps": 2}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        body = json.loads(r.read())
    assert body["ckpt_name"] == "tiny.safetensors"
    assert set(body["timings"]) == {"clip_s", "sample_s", "vae_s",
                                    "total_s"}
    assert all(v >= 0 for v in body["timings"].values())
