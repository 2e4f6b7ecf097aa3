"""The HTTP fan-out over real sockets, on the CPU at the tiny family's
size: a torch master (``cli serve --device cpu``) with a torch worker
(``cli worker --device cpu``), and the same master with the JAX
package's own ``cli worker`` (the test that the HTTP surface is the
same).

Images are read back from the master's SaveImage files, 8-bit PNGs, so
each comparison is between 8-bit images: ``to_uint8(reference) / 255``
against the file.  The tensor wire is lossless, so a generated image
equals the port's single-process run exactly there (1e-6), and so does
the tiled upscale against a single-process run whose tiles are refined
in the fan-out's batches (tiles 0-1, then 2-3).  Against one batch of
all four tiles the blended floats move by up to 9.4e-6 on this CPU
(measured), which may flip an 8-bit value by one step: the bound there
is one step (1/255) on at most 1% of the values.
A float difference within the 2e-3 that the port holds against the JAX
executor also moves an 8-bit value by at most one step, so against the
JAX package's images the bound is one step."""

import copy
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import upscalers as tup
from comfyui_distributed_tpu_torch.ops import tiling
from comfyui_distributed_tpu_torch.ops.base import OpContext
from comfyui_distributed_tpu_torch.ops.tiled_upscale import (
    UltimateSDUpscaleDistributed as Upscaler)
from comfyui_distributed_tpu_torch.utils.image import (decode_png,
                                                       encode_png, save_png,
                                                       to_uint8)
from comfyui_distributed_tpu_torch.utils.net import (find_free_port,
                                                     get_json, post_json)
from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor

pytestmark = pytest.mark.integration

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEADLINE_S = 180          # each test's own limit
EXACT = 1e-6              # the lossless tensor wire
ONE_STEP = 1.0 / 255 + 1e-6
SEED = 123456789
# the tiny RRDB in fp32 in every process, as tests/test_torch_port_
# upscale.py runs it: its bf16 convolutions round differently in XLA
# and in torch, and the refine amplifies one bf16 step past 2e-3
TORCH_CLI = ("import dataclasses, sys, torch\n"
             "from comfyui_distributed_tpu_torch.models import upscalers\n"
             "upscalers.TINY_RRDB_CONFIG = dataclasses.replace("
             "upscalers.TINY_RRDB_CONFIG, dtype=torch.float32)\n"
             "from comfyui_distributed_tpu_torch import cli\n"
             "sys.exit(cli.main(sys.argv[1:]))\n")


def _txt2img(seed=SEED, save=True):
    doc = json.loads((ROOT / "workflows" / "distributed-txt2img.json")
                     .read_text())
    doc["5"]["inputs"].update(width=64, height=64)
    doc["3"]["inputs"]["steps"] = 4
    doc["13"]["inputs"]["seed"] = seed
    if save:
        doc["9"]["class_type"] = "SaveImage"
    return doc


def _upscale(save=True):
    doc = json.loads((ROOT / "workflows" / "distributed-upscale.json")
                     .read_text())
    doc["16"]["inputs"].update(width=64, height=64)
    doc["2"]["inputs"].update(steps=2, tile_width=32, tile_height=32,
                              padding=8, mask_blur=2)
    if save:
        doc["9"]["class_type"] = "SaveImage"
    return doc


def _hires(seed=SEED, save=True):
    """distributed-hires-fix.json shrunk as tests/test_workflow.py shrinks
    it: 32^2 and 64^2 pixel widgets, one step in each window of two."""
    doc = json.loads((ROOT / "workflows" / "distributed-hires-fix.json")
                     .read_text())
    doc["5"]["inputs"].update(width=32, height=32)
    doc["3"]["inputs"].update(steps=2, end_at_step=1)
    doc["10"]["inputs"].update(width=64, height=64)
    doc["11"]["inputs"].update(steps=2, start_at_step=1)
    doc["13"]["inputs"]["seed"] = seed
    if save:
        doc["9"]["class_type"] = "SaveImage"
    return doc


def _regional(seed=SEED):
    """distributed-regional.json at the tiny family's size: 64^2, 3
    steps (its SaveImage kept)."""
    doc = json.loads((ROOT / "workflows" / "distributed-regional.json")
                     .read_text())
    doc["2"]["inputs"].update(width=64, height=64)
    doc["3"]["inputs"]["steps"] = 3
    doc["13"]["inputs"]["seed"] = seed
    return doc


def _input_png(path):
    """The small input image every participant loads (48 x 40)."""
    rng = np.random.default_rng(8)
    save_png(str(path), rng.uniform(size=(40, 48, 3)).astype(np.float32))


def _inpaint(seed=SEED, save=True):
    """distributed-inpaint.json at the tiny family's size: the input
    scaled to 64^2, 3 steps."""
    doc = json.loads((ROOT / "workflows" / "distributed-inpaint.json")
                     .read_text())
    doc["2"]["inputs"].update(width=64, height=64)
    doc["3"]["inputs"]["steps"] = 3
    doc["13"]["inputs"]["seed"] = seed
    if save:
        doc["9"]["class_type"] = "SaveImage"
    return doc


def _rgba_input():
    """An 80 x 60 RGBA card with a transparent rectangle (the region
    to inpaint): the pixels [60, 80, 4] and the PNG's bytes."""
    img = np.random.default_rng(9).uniform(size=(60, 80, 4)).astype(
        np.float32)
    img[..., 3] = 1.0
    img[18:42, 30:56, 3] = 0.0
    return img, encode_png(img)


class Cluster:
    def __init__(self, root):
        self.root = root
        self.procs, self.ports, self.dirs = {}, {}, {}
        env = {**os.environ, "DTPU_DEFAULT_FAMILY": "tiny",
               "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
               "DTPU_COMPILE_CACHE_DIR": "off"}
        for name, argv in (
                ("master", [sys.executable, "-c", TORCH_CLI, "serve"]),
                ("w0", [sys.executable, "-c", TORCH_CLI, "worker"]),
                ("j0", [sys.executable, "-m", "comfyui_distributed_tpu.cli",
                        "worker"])):
            d = root / name
            (d / "input").mkdir(parents=True)
            _input_png(d / "input" / "input.png")
            port = find_free_port()
            args = ["--host", "127.0.0.1", "--port", str(port),
                    "--config", str(d / "cfg.json")]
            if name != "j0":
                args += ["--device", "cpu", "--input-dir", str(d / "input"),
                         "--output-dir", str(d / "output")]
            log = open(d / "log.txt", "w")
            self.procs[name] = (subprocess.Popen(
                argv + args, cwd=str(d), env=env, stdout=log,
                stderr=subprocess.STDOUT), log)
            self.ports[name], self.dirs[name] = port, d

    def url(self, name):
        return f"http://127.0.0.1:{self.ports[name]}"

    def wait_up(self, timeout=120):
        deadline = time.time() + timeout
        for name, (proc, _) in self.procs.items():
            while True:
                assert proc.poll() is None, self.logs()
                try:
                    get_json(self.url(name) + "/prompt", timeout=2)
                    break
                except OSError:
                    assert time.time() < deadline, self.logs()
                    time.sleep(0.3)

    def logs(self):
        return "\n".join(f"--- {n} ---\n"
                         + (self.dirs[n] / "log.txt").read_text()[-3000:]
                         for n in self.procs)

    def enable_only(self, name):
        for w in ("w0", "j0"):
            post_json(self.url("master") + "/distributed/config/update_worker",
                      {"id": w, "name": w, "host": "127.0.0.1",
                       "port": self.ports[w], "enabled": w == name})

    def outputs(self, name="master"):
        d = self.dirs[name] / "output"
        return sorted(d.glob("*.png")) if d.exists() else []

    def run(self, doc, deadline, extra_data=None):
        """POST ``doc`` (with ``extra_data``) to the master; returns
        (response, history entry, metrics delta, new PNG paths)."""
        url = self.url("master")
        m0 = get_json(url + "/distributed/metrics")
        before = set(self.outputs())
        body = {"prompt": doc, "client_id": "t"}
        if extra_data is not None:
            body["extra_data"] = extra_data
        resp = post_json(url + "/prompt", body)
        while resp["prompt_id"] not in get_json(url + "/history"):
            assert time.time() < deadline, self.logs()
            time.sleep(0.2)
        entry = get_json(url + "/history")[resp["prompt_id"]]
        m1 = get_json(url + "/distributed/metrics")
        delta = {k: m1[k] - m0[k] for k in m0 if isinstance(m0[k], int)}
        return resp, entry, delta, sorted(set(self.outputs()) - before)

    def stop(self):
        for proc, _ in self.procs.values():
            proc.terminate()
        for proc, log in self.procs.values():
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            log.close()


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = Cluster(tmp_path_factory.mktemp("fanout"))
    try:
        c.wait_up()
        yield c
    finally:
        c.stop()


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """Single-process images of the port and of the JAX package: txt2img
    at SEED and SEED + 1, and the upscale; tiny family, fp32 tiny RRDB."""
    import jax.numpy as jnp

    from comfyui_distributed_tpu.models import registry as jreg
    from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
    from comfyui_distributed_tpu.workflow import \
        WorkflowExecutor as JaxExecutor
    inp = tmp_path_factory.mktemp("refs_input")
    _input_png(inp / "input.png")
    saved = (os.environ.get("DTPU_DEFAULT_FAMILY"), tup.TINY_RRDB_CONFIG,
             jreg.TINY_RRDB_CONFIG, jreg._upscaler_cache)
    os.environ["DTPU_DEFAULT_FAMILY"] = "tiny"
    tup.TINY_RRDB_CONFIG = dataclasses.replace(tup.TINY_RRDB_CONFIG,
                                               dtype=torch.float32)
    jreg.TINY_RRDB_CONFIG = dataclasses.replace(jreg.TINY_RRDB_CONFIG,
                                                dtype=jnp.float32)
    jreg._upscaler_cache = {}
    out = {"torch": {}, "jax": {}}

    def port(doc):
        return WorkflowExecutor(OpContext(device="cpu", input_dir=str(
            inp))).execute(copy.deepcopy(doc)).image_batch[0]

    try:
        docs = {SEED: _txt2img(SEED, save=False),
                SEED + 1: _txt2img(SEED + 1, save=False),
                "upscale": _upscale(save=False)}
        for key, doc in docs.items():
            out["torch"][key] = port(doc)
            res = JaxExecutor(JaxOpContext(input_dir=str(inp))).execute(
                copy.deepcopy(doc))
            res.wait_host()
            out["jax"][key] = res.image_batch[0]
        # the tiles refined in the fan-out's batches, in this process
        whole = Upscaler._refine_tiles

        def in_parts(self, ctx, pipe, image, all_tiles, indices, *a):
            out = {}
            for part in tiling.partition_tiles(len(indices), 1):
                out.update(whole(self, ctx, pipe, image, all_tiles,
                                 [indices[i] for i in part], *a))
            return out

        Upscaler._refine_tiles = in_parts
        try:
            out["torch"]["upscale_parts"] = port(docs["upscale"])
        finally:
            Upscaler._refine_tiles = whole
    finally:
        if saved[0] is None:
            os.environ.pop("DTPU_DEFAULT_FAMILY", None)
        else:
            os.environ["DTPU_DEFAULT_FAMILY"] = saved[0]
        tup.TINY_RRDB_CONFIG, jreg.TINY_RRDB_CONFIG, \
            jreg._upscaler_cache = saved[1:]
        treg.clear_pipeline_cache()
    return out


def _diff(png_path, ref, share=False):
    """max |8-bit file - 8-bit reference| in [0, 1] (and, with
    ``share``, the share of values that differ)."""
    got = decode_png(png_path.read_bytes())[0]
    want = to_uint8(ref).astype(np.float32) / 255.0
    assert got.shape == want.shape
    d = np.abs(got - want)
    return (float(d.max()), float((d > 0).mean())) if share \
        else float(d.max())


def _parallel_generation(cluster, worker):
    deadline = time.time() + DEADLINE_S
    cluster.enable_only(worker)
    resp, entry, delta, files = cluster.run(_txt2img(), deadline)
    assert resp["workers"] == [worker] and resp["failed_workers"] == [], \
        (resp, cluster.logs())
    assert entry["status"] == "success" and entry["images"] == 2, entry
    assert delta["images_received"] == 1 and delta["tiles_received"] == 0
    assert len(files) == 2
    # SaveImage stores the graph that ran: the master's prepared share
    from PIL import Image
    with Image.open(files[0]) as im:
        prompt = json.loads(im.text["prompt"])
    assert prompt["14"]["hidden"]["enabled_worker_ids"] == f'["{worker}"]'
    return files, delta


def test_parallel_generation_torch_worker(cluster, refs):
    """Image 0 is the master's, at seed s; image 1 the worker's, at
    s + 1, sent over /distributed/job_complete as a zlib tensor."""
    files, delta = _parallel_generation(cluster, "w0")
    assert delta["wire_tensor_msgs"] == 1 and delta["wire_png_msgs"] == 0
    for f, seed in zip(files, (SEED, SEED + 1)):
        assert _diff(f, refs["torch"][seed]) <= EXACT, (f, seed)
        assert _diff(f, refs["jax"][seed]) <= ONE_STEP, (f, seed)
    # a wrong seed is far off
    assert _diff(files[1], refs["torch"][SEED]) > 0.1


def test_distributed_upscale_torch_worker(cluster, refs):
    """partition_tiles(4, 1): tiles 0-1 on the master, 2-3 on the worker,
    POSTed to /distributed/tile_complete and blended with the master's.
    Each side refines its two tiles as a batch of two, against one batch
    of four in one process (see the module's note on the bound)."""
    deadline = time.time() + DEADLINE_S
    cluster.enable_only("w0")
    assert tiling.partition_tiles(4, 1) == [[0, 1], [2, 3]]
    resp, entry, delta, files = cluster.run(_upscale(), deadline)
    assert resp["workers"] == ["w0"] and resp["failed_workers"] == [], \
        (resp, cluster.logs())
    assert entry["status"] == "success" and entry["images"] == 1, entry
    assert delta["tiles_received"] == 2 and delta["images_received"] == 0
    (f,) = files
    assert _diff(f, refs["torch"]["upscale_parts"]) <= EXACT
    dmax, share = _diff(f, refs["torch"]["upscale"], share=True)
    assert dmax <= ONE_STEP and share <= 0.01, (dmax, share)
    assert _diff(f, refs["jax"]["upscale"]) <= ONE_STEP


def test_torch_master_with_jax_worker(cluster, refs):
    """The JAX package's own ``cli worker`` behind the port's master: it
    negotiates the tensor wire (zlib, the only codec the port lists), and
    the gathered batch equals the all-torch cluster's: image 0 (the
    master's) exactly, image 1 (the JAX worker's) within one 8-bit
    step."""
    files, delta = _parallel_generation(cluster, "j0")
    assert delta["wire_tensor_msgs"] == 1 and delta["wire_png_msgs"] == 0
    assert _diff(files[0], refs["torch"][SEED]) <= EXACT
    assert _diff(files[1], refs["torch"][SEED + 1]) <= ONE_STEP
    assert _diff(files[1], refs["jax"][SEED + 1]) <= ONE_STEP
    cluster.enable_only("w0")


def test_cli_run_via_master(cluster, tmp_path, capsys):
    """``cli run --via``: queued on the master, which fans it out."""
    from comfyui_distributed_tpu_torch import cli
    cluster.enable_only("w0")
    wf = tmp_path / "wf.json"
    wf.write_text(json.dumps(_txt2img(SEED + 7)))
    assert cli.main(["run", str(wf), "--via", cluster.url("master"),
                     "--timeout", str(DEADLINE_S)]) == 0
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1])["images"] == 2
    assert "dispatched to workers: ['w0']" in out.err


def test_hires_fix_through_master_and_worker(cluster, monkeypatch):
    """The staged hires-fix (LoraLoader, CLIPSetLastLayer, two
    KSamplerAdvanced windows around a LatentUpscale) fanned out: the
    worker's DistributedSeed gives s + 1 to both of its windows, so its
    image is the in-process run at s + 1 (the JAX executor's within one
    8-bit step), and the master's the run at s."""
    from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
    from comfyui_distributed_tpu.workflow import \
        WorkflowExecutor as JaxExecutor
    deadline = time.time() + DEADLINE_S
    cluster.enable_only("w0")
    resp, entry, delta, files = cluster.run(_hires(), deadline)
    assert resp["workers"] == ["w0"] and resp["failed_workers"] == [], \
        (resp, cluster.logs())
    assert entry["status"] == "success" and entry["images"] == 2, entry
    assert delta["images_received"] == 1 and len(files) == 2
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny")
    treg.clear_pipeline_cache()
    try:
        refs = {s: WorkflowExecutor(OpContext(device="cpu")).execute(
            _hires(s, save=False)).image_batch[0] for s in (SEED, SEED + 1)}
        jres = JaxExecutor(JaxOpContext()).execute(_hires(SEED + 1,
                                                          save=False))
        jres.wait_host()
    finally:
        treg.clear_pipeline_cache()
    for f, seed in zip(files, (SEED, SEED + 1)):
        assert _diff(f, refs[seed]) <= EXACT, (f, seed)
    assert _diff(files[1], jres.image_batch[0]) <= ONE_STEP
    assert _diff(files[1], refs[SEED]) > ONE_STEP


def test_regional_through_master_and_worker(cluster, monkeypatch):
    """The regional workflow fanned out: each share runs both area
    entries and the uncond in one stacked call, the worker at s + 1; the
    saved images equal the in-process runs at s and s + 1 (each a batch
    of one, as each share is)."""
    deadline = time.time() + DEADLINE_S
    cluster.enable_only("w0")
    resp, entry, delta, files = cluster.run(_regional(), deadline)
    assert resp["workers"] == ["w0"] and resp["failed_workers"] == [], \
        (resp, cluster.logs())
    assert entry["status"] == "success" and entry["images"] == 2, entry
    assert delta["images_received"] == 1 and len(files) == 2
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny")
    treg.clear_pipeline_cache()
    try:
        refs = {s: WorkflowExecutor(OpContext(device="cpu")).execute(
            _regional(s)).image_batch[0] for s in (SEED, SEED + 1)}
    finally:
        treg.clear_pipeline_cache()
    for f, seed in zip(files, (SEED, SEED + 1)):
        assert _diff(f, refs[seed]) <= EXACT, (f, seed)
    assert _diff(files[1], refs[SEED]) > ONE_STEP


def _text_chunks(path):
    """[(key, value)] of a PNG's tEXt chunks, in file order."""
    data, out, pos = pathlib.Path(path).read_bytes(), [], 8
    while pos + 8 <= len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        if data[pos + 4:pos + 8] == b"tEXt":
            key, _, value = data[pos + 8:pos + 8 + n].partition(b"\0")
            out.append((key.decode("latin-1"), value.decode("latin-1")))
        pos += 12 + n
    return out


def test_saved_pngs_carry_the_requests_extra_pnginfo(cluster, tmp_path):
    """The request's ``extra_data["extra_pnginfo"]`` reaches SaveImage on
    the master and on the worker: each PNG holds ``prompt`` (its own
    share's graph) and ``workflow``, with the chunks, keys and values
    the JAX package's SaveImage writes for that graph."""
    from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
    from comfyui_distributed_tpu.ops.basic import SaveImage as JaxSaveImage
    deadline = time.time() + DEADLINE_S
    cluster.enable_only("w0")
    doc = _txt2img(SEED + 3)
    # each participant also saves its own share's image
    doc["20"] = {"class_type": "SaveImage",
                 "inputs": {"images": ["8", 0], "filename_prefix": "share"}}
    extra = {"extra_pnginfo": {"workflow": {
        "last_node_id": 20, "nodes": [{"id": 3, "type": "KSampler"}],
        "links": [], "version": 0.4}}}
    w_before = set(cluster.outputs("w0"))
    resp, entry, _, files = cluster.run(doc, deadline, extra_data=extra)
    assert entry["status"] == "success" and resp["workers"] == ["w0"]
    mine = [f for f in files if f.name.startswith("share_")]
    theirs = [f for f in cluster.outputs("w0")
              if f not in w_before and f.name.startswith("share_")]
    assert len(mine) == 1 and len(theirs) == 1, (files, theirs)
    for f, role in ((mine[0], "master"), (theirs[0], "worker")):
        got = _text_chunks(f)
        assert [k for k, _ in got] == ["prompt", "workflow"], (role, got)
        prompt = json.loads(got[0][1])
        assert prompt["20"]["class_type"] == "SaveImage"
        # the JAX SaveImage on the same graph, extra_pnginfo and image
        out = tmp_path / role
        JaxSaveImage().execute(
            JaxOpContext(output_dir=str(out), prompt_json=prompt,
                         extra_pnginfo=extra["extra_pnginfo"]),
            decode_png(f.read_bytes()), filename_prefix="ref")
        assert got == _text_chunks(out / "ref_00000.png"), role


def test_inpaint_through_master_and_remote_worker(cluster, tmp_path,
                                                   monkeypatch):
    """distributed-inpaint.json fanned out to a worker the master counts
    as remote (a second torch worker on 127.0.0.2, its input directory
    empty): the master stages its RGBA ``input.png`` there byte for
    byte, and collects 2 images, each equal to the in-process run at
    seed s (the master's) and s + 1 (the worker's); the two differ
    inside the mask."""
    deadline = time.time() + DEADLINE_S
    card, png = _rgba_input()
    master_png = cluster.dirs["master"] / "input" / "input.png"
    saved = master_png.read_bytes()
    d = tmp_path / "w1"
    (d / "input").mkdir(parents=True)
    port = find_free_port()
    env = {**os.environ, "DTPU_DEFAULT_FAMILY": "tiny",
           "PYTHONPATH": str(ROOT)}
    log = open(d / "log.txt", "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", TORCH_CLI, "worker", "--host", "127.0.0.2",
         "--port", str(port), "--config", str(d / "cfg.json"), "--device",
         "cpu", "--input-dir", str(d / "input"), "--output-dir",
         str(d / "output")], cwd=str(d), env=env, stdout=log,
        stderr=subprocess.STDOUT)
    url = cluster.url("master") + "/distributed/config/update_worker"
    try:
        while True:
            assert proc.poll() is None, (d / "log.txt").read_text()
            try:
                get_json(f"http://127.0.0.2:{port}/prompt", timeout=2)
                break
            except OSError:
                assert time.time() < deadline, (d / "log.txt").read_text()
                time.sleep(0.3)
        master_png.write_bytes(png)
        cluster.enable_only(None)
        post_json(url, {"id": "w1", "name": "w1", "host": "127.0.0.2",
                        "port": port, "enabled": True})
        resp, entry, delta, files = cluster.run(_inpaint(), deadline)
        assert resp["workers"] == ["w1"] and resp["failed_workers"] == [], \
            (resp, cluster.logs(), (d / "log.txt").read_text())
        assert entry["status"] == "success" and entry["images"] == 2, entry
        assert delta["images_received"] == 1 and len(files) == 2
        assert (d / "input" / "input.png").read_bytes() == png
    finally:
        post_json(url, {"id": "w1", "name": "w1", "host": "127.0.0.2",
                        "port": port, "enabled": False})
        master_png.write_bytes(saved)
        cluster.enable_only("w0")
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
    inp = tmp_path / "in"
    inp.mkdir()
    (inp / "input.png").write_bytes(png)
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny")
    treg.clear_pipeline_cache()
    try:
        refs = {s: WorkflowExecutor(OpContext(
            device="cpu", input_dir=str(inp))).execute(
                _inpaint(s, save=False)).image_batch[0]
            for s in (SEED, SEED + 1)}
    finally:
        treg.clear_pipeline_cache()
    for f, seed in zip(files, (SEED, SEED + 1)):
        assert _diff(f, refs[seed]) <= EXACT, (f, seed)
    # the card's transparent rectangle, scaled to 64^2 (80 -> 64 wide,
    # 60 -> 64 high)
    got = [decode_png(f.read_bytes())[0] for f in files]
    hole = (slice(20, 44), slice(24, 44))
    assert np.abs(got[0][hole] - got[1][hole]).mean() > 0.02

