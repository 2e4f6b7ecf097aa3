"""The port's worker process manager and master-death monitor on the
CPU, mirroring the JAX package's ``tests/test_runtime.py``: launch,
track and stop; a double launch; PID persistence; the log; auto-launch;
the monitor; a stop during a launch.  Each test runs twice: with psutil
and with psutil patched out, so the ``ps`` branch of
``utils/process.py`` (the one a machine without psutil takes) is tested
too.  One test launches a real port worker (``cli worker --device
cpu``) through a CPU master's route.

Every wait has its own bound (``wait_for``), so no test can hang."""

import os
import pathlib
import subprocess
import sys
import threading
import time

import pytest

from comfyui_distributed_tpu_torch.runtime import manager as mgr_mod
from comfyui_distributed_tpu_torch.server.app import ServerState, make_server
from comfyui_distributed_tpu_torch.utils import config as cfg_mod
from comfyui_distributed_tpu_torch.utils import process as tproc
from comfyui_distributed_tpu_torch.utils.net import (find_free_port,
                                                     get_json, post_json)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SLEEPER = [sys.executable, "-c", "import time; time.sleep(60)"]
MONITOR = "comfyui_distributed_tpu_torch.runtime.monitor"
# a monitor process without psutil: its import fails as on a machine
# without it, then the module runs as ``python -m`` would run it
NO_PSUTIL_MONITOR = ("import runpy, sys; sys.modules['psutil'] = None; "
                     f"sys.argv[0] = {MONITOR!r}; "
                     f"runpy.run_module({MONITOR!r}, run_name='__main__')")


def wait_for(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: not within {timeout} s")
        time.sleep(0.05)


@pytest.fixture(params=["psutil", "ps"])
def branch(request, monkeypatch):
    if request.param == "psutil":
        assert tproc.psutil is not None, "psutil is not installed"
    else:
        monkeypatch.setattr(tproc, "psutil", None)
    return request.param


def monitor_cmd(branch, master_pid, cmd):
    head = [sys.executable, "-m", MONITOR] if branch == "psutil" \
        else [sys.executable, "-c", NO_PSUTIL_MONITOR]
    return head + ["--master-pid", str(master_pid), "--"] + cmd


@pytest.fixture
def manager(tmp_path, monkeypatch, branch):
    m = mgr_mod.WorkerProcessManager(config_path=str(tmp_path / "cfg.json"),
                                     log_dir=str(tmp_path / "logs"))
    # no real worker server in the unit tests
    monkeypatch.setattr(m, "build_launch_command", lambda w: list(SLEEPER))
    yield m
    m.cleanup_all()


def test_launch_tracks_and_stops(manager, branch, capsys):
    entry = manager.launch_worker({"id": "w1", "name": "t", "port": 1},
                                  stop_on_master_exit=False)
    assert tproc.is_process_alive(entry["pid"])
    managed = manager.get_managed_workers()
    assert managed["w1"]["alive"] is True
    assert managed["w1"]["launching"] is True
    manager.clear_launching("w1")
    assert manager.get_managed_workers()["w1"]["launching"] is False
    assert manager.stop_worker("w1") is True
    assert not tproc.is_process_alive(entry["pid"])
    assert f"kill branch {branch}" in capsys.readouterr().out
    assert manager.stop_worker("w1") is False


def test_double_launch_conflicts(manager):
    manager.launch_worker({"id": "w1", "port": 1}, stop_on_master_exit=False)
    with pytest.raises(RuntimeError, match="already running"):
        manager.launch_worker({"id": "w1", "port": 1},
                              stop_on_master_exit=False)


def test_pid_persistence_revives_live_and_purges_stale(manager, tmp_path):
    entry = manager.launch_worker({"id": "w1", "port": 1},
                                  stop_on_master_exit=False)
    path = str(tmp_path / "cfg.json")
    cfg = cfg_mod.load_config(path)
    assert cfg["managed_processes"]["w1"]["pid"] == entry["pid"]
    assert "process" not in cfg["managed_processes"]["w1"]
    cfg["managed_processes"]["dead"] = {"pid": 999999}
    cfg_mod.save_config(cfg, path)
    m2 = mgr_mod.WorkerProcessManager(config_path=path,
                                      log_dir=str(tmp_path / "logs"))
    assert "w1" in m2.processes            # alive: revived
    assert "dead" not in m2.processes      # stale: purged
    assert "dead" not in cfg_mod.load_config(path)["managed_processes"]
    m2.processes.pop("w1")                 # the fixture's manager owns it


def test_log_has_the_session_header_and_is_tailed(manager):
    entry = manager.launch_worker({"id": "w1", "name": "logtest", "port": 1},
                                  stop_on_master_exit=False)
    assert os.path.basename(entry["log_file"]) \
        == f"logtest_{time.strftime('%Y%m%d')}.log"
    text = manager.tail_log("w1")
    assert "=== session" in text and "cmd=" in text
    assert manager.tail_log("w1", max_bytes=8) == text[-8:]
    with pytest.raises(FileNotFoundError):
        manager.tail_log("nope")


def test_auto_launch_respects_the_settings_and_skips_remote(manager,
                                                            tmp_path):
    path = str(tmp_path / "cfg.json")
    cfg = cfg_mod.load_config(path)
    cfg_mod.upsert_worker(cfg, {"id": "w1", "port": 1, "enabled": True})
    cfg_mod.upsert_worker(cfg, {"id": "remote", "port": 2, "enabled": True,
                                "host": "10.0.0.9"})
    cfg_mod.upsert_worker(cfg, {"id": "off", "port": 3})
    cfg_mod.save_config(cfg, path)
    # the setting is false by default: nothing starts
    mgr_mod.auto_launch_workers(manager, delay=0.01).join(timeout=5)
    assert manager.get_managed_workers() == {}
    cfg_mod.mutate_config(lambda c: cfg_mod.update_setting(
        c, "auto_launch_workers", True), path)
    mgr_mod.auto_launch_workers(manager, delay=0.01).join(timeout=5)
    wait_for(lambda: "w1" in manager.get_managed_workers(), 5, "auto-launch")
    managed = manager.get_managed_workers()
    assert set(managed) == {"w1"}        # remote and disabled: skipped
    pid = managed["w1"]["pid"]
    # a running worker is not launched again
    mgr_mod.auto_launch_workers(manager, delay=0.01).join(timeout=5)
    assert manager.get_managed_workers()["w1"]["pid"] == pid


def test_a_stop_during_the_launch_kills_the_new_process(manager,
                                                        monkeypatch):
    spawned = []
    real = tproc.popen_detached

    def popen_then_stop(*a, **kw):
        p = real(*a, **kw)
        spawned.append(p.pid)
        assert manager.stop_worker("w1") is True   # takes the reservation
        return p

    monkeypatch.setattr(tproc, "popen_detached", popen_then_stop)
    with pytest.raises(RuntimeError, match="stopped during launch"):
        manager.launch_worker({"id": "w1", "port": 1},
                              stop_on_master_exit=False)
    assert spawned and not tproc.is_process_alive(spawned[0])
    assert manager.get_managed_workers() == {}


def test_a_tree_that_cannot_be_listed_raises(manager, branch, monkeypatch):
    """Without psutil the tree comes from ``ps``; with ``ps`` missing the
    stop raises and the worker stays managed, instead of reporting a
    stop whose children run on."""
    entry = manager.launch_worker({"id": "w1", "port": 1},
                                  stop_on_master_exit=False)
    if branch == "ps":
        def no_ps(*a, **kw):
            raise FileNotFoundError("ps")
        monkeypatch.setattr(tproc.subprocess, "run", no_ps)
        with pytest.raises(OSError):
            manager.stop_worker("w1")
        assert tproc.is_process_alive(entry["pid"])
        assert "w1" in manager.get_managed_workers()
        monkeypatch.undo()
        monkeypatch.setattr(tproc, "psutil", None)
    assert manager.stop_worker("w1") is True
    assert not tproc.is_process_alive(entry["pid"])


def test_the_tree_kill_reaches_grandchildren(branch):
    """A parent, its child and its grandchild: all three die, and the
    branch is the one asked for."""
    code = ("import subprocess, sys, time; "
            "subprocess.Popen([sys.executable, '-c', "
            "'import subprocess, sys, time; subprocess.Popen([sys.executable,"
            " \"-c\", \"import time; time.sleep(60)\"]); time.sleep(60)']); "
            "time.sleep(60)")
    root = subprocess.Popen([sys.executable, "-c", code])
    try:
        wait_for(lambda: len(tproc._descendants(root.pid)) == 2, 20,
                 "two descendants")
        tree = tproc._descendants(root.pid) + [root.pid]
        ok, used = tproc.kill_process_tree(root.pid, timeout=5)
        assert ok and used == branch
        root.wait(timeout=5)
        wait_for(lambda: not any(tproc.is_process_alive(p) for p in tree),
                 10, "the tree's death")
        assert tproc.kill_process_tree(root.pid) == (True, "gone")
    finally:
        if root.poll() is None:
            root.kill()
            root.wait()


# --- the monitor ---------------------------------------------------------------

def test_the_monitor_kills_the_worker_when_the_master_dies(branch):
    fake_master = subprocess.Popen([sys.executable, "-c",
                                    "import time; time.sleep(2)"])
    mon = subprocess.Popen(monitor_cmd(branch, fake_master.pid, SLEEPER),
                           cwd=ROOT)
    try:
        wait_for(lambda: tproc._descendants(mon.pid), 20, "the worker")
        worker = tproc._descendants(mon.pid)[0]
        fake_master.wait(timeout=10)
        assert mon.wait(timeout=20) == 0
        wait_for(lambda: not tproc.is_process_alive(worker), 10,
                 "the worker's death")
    finally:
        for p in (mon, fake_master):
            if p.poll() is None:
                p.kill()
                p.wait()


def test_the_monitor_propagates_the_workers_exit_code(branch):
    mon = subprocess.Popen(monitor_cmd(
        branch, os.getpid(), [sys.executable, "-c",
                              "import sys; sys.exit(7)"]), cwd=ROOT)
    try:
        assert mon.wait(timeout=20) == 7
    finally:
        if mon.poll() is None:
            mon.kill()
            mon.wait()


# --- a real port worker through a CPU master's routes -----------------------

def test_a_real_worker_launches_clears_launching_and_stops(tmp_path,
                                                           monkeypatch,
                                                           branch):
    """``POST /distributed/launch_worker`` starts ``cli worker --device
    cpu`` under the monitor; the health poller's first contact clears
    ``launching``; ``stop_worker`` leaves no process of the tree
    alive."""
    monkeypatch.chdir(tmp_path)    # the worker logs go to ./logs/workers
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    wport = find_free_port()
    cfg_path = str(tmp_path / "cfg.json")
    st = ServerState(config_path=cfg_path, device="cpu",
                     start_exec_thread=False)
    srv = make_server(st, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{st.port}"
    cfg_mod.mutate_config(lambda c: (
        cfg_mod.update_master(c, host="127.0.0.1", port=st.port),
        cfg_mod.upsert_worker(c, {
            "id": "w0", "name": "w0", "port": wport, "enabled": True,
            "extra_args": f"--host 127.0.0.1 --device cpu --input-dir "
                          f"{tmp_path / 'in'} --output-dir "
                          f"{tmp_path / 'out'}"})), cfg_path)
    try:
        entry = post_json(url + "/distributed/launch_worker",
                          {"id": "w0"})["worker"]
        assert entry["launching"] is True
        with pytest.raises(RuntimeError, match="409"):
            post_json(url + "/distributed/launch_worker", {"id": "w0"})
        managed = get_json(url + "/distributed/managed_workers")
        assert managed["w0"]["alive"] is True

        def polled_online():
            return st.health.poll_once()["w0"]["status"] == "online"

        wait_for(polled_online, 90, "the worker's first contact")
        assert get_json(url + "/distributed/managed_workers")["w0"][
            "launching"] is False
        assert get_json(url + "/distributed/workers_status")["w0"][
            "status"] == "online"
        log_text = get_json(url + "/distributed/worker_log?id=w0")["log"]
        assert "=== session" in log_text and MONITOR in log_text
        assert "worker listening on 127.0.0.1" in log_text
        tree = tproc._descendants(entry["pid"]) + [entry["pid"]]
        assert len(tree) >= 2            # the monitor and the worker
        assert post_json(url + "/distributed/stop_worker",
                         {"id": "w0"}) == {"status": "ok"}
        assert not any(tproc.is_process_alive(p) for p in tree)
        with pytest.raises(RuntimeError, match="404"):
            post_json(url + "/distributed/stop_worker", {"id": "w0"})
    finally:
        st.manager.cleanup_all()
        srv.shutdown()
        srv.server_close()
