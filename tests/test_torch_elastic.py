"""`parallel.elastic` and `parallel.launch` of the port: the JAX
package's unit tests (`tests/test_elastic.py`) on the port's
controller, with standard-library worker scripts (they start in tens
of milliseconds, so the stale-heartbeat test waits 1.5 s where JAX's
waits 12) and a free port per test (bound once to port 0; JAX's tests
fix ports 9600-9710).

- `Heartbeat`: beats refresh the file; no directory, no thread.
- The controller: a gang restart on a non-zero exit with the endpoint
  rewritten (base port + incarnation), the restart budget, a hang
  found by its stale heartbeat, a permanently lost slot shrinking the
  gang (the top one and one mid-gang), `min_np`, the `np_request`
  scale-out, and the whole-run `timeout`.
- `launch_local` and `build_worker_env`: the variables each worker
  sees, a failed worker stopping the others, the timeout; `python -m
  paddle_tpu_torch.parallel.launch` starting the workers.
"""
import os
import subprocess
import sys
import textwrap
import time

import pytest

from paddle_tpu_torch.parallel.elastic import ElasticController, Heartbeat
from paddle_tpu_torch.parallel.launch import (build_worker_env, free_port,
                                              launch_local)
from port_threads import one_torch_thread  # noqa: F401


def _master():
    return f"127.0.0.1:{free_port()}"


def _write(tmp_path, name, body):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        f.write(textwrap.dedent(body))
    return path


def test_heartbeat(tmp_path):
    hb = Heartbeat(str(tmp_path), rank=3, interval=0.05)
    with hb:
        assert os.path.exists(tmp_path / "hb.3")
        t0 = os.path.getmtime(tmp_path / "hb.3")
        time.sleep(0.2)
    assert os.path.getmtime(tmp_path / "hb.3") > t0
    hb = Heartbeat(directory=None)
    hb.start()
    assert hb._thread is None
    hb.stop()


def test_restart_on_failure_and_endpoint_rewrite(tmp_path, monkeypatch):
    script = _write(tmp_path, "flaky.py", """
        import os, sys
        inc = int(os.environ["PTPU_ELASTIC_INCARNATION"])
        with open(os.environ["OUT"], "a") as f:
            f.write(os.environ["PTPU_COORDINATOR"] + "\\n")
        sys.exit(1 if inc == 0 else 0)
        """)
    out = str(tmp_path / "endpoints.txt")
    monkeypatch.setenv("OUT", out)
    master = _master()
    ctrl = ElasticController(script, nproc=1, master=master, max_restarts=2,
                             poll_interval=0.05)
    assert ctrl.run() == 0
    assert ctrl.restarts == 1
    eps = open(out).read().split()
    host, port = master.rsplit(":", 1)
    assert eps == [master, f"{host}:{int(port) + 1}"]


def test_restart_budget_exhausted(tmp_path):
    script = _write(tmp_path, "dies.py", "import sys; sys.exit(3)\n")
    ctrl = ElasticController(script, nproc=1, master=_master(),
                             max_restarts=1, poll_interval=0.05)
    assert ctrl.run() == 1
    assert ctrl.restarts == 2


def test_stale_heartbeat_detects_hang(tmp_path):
    script = _write(tmp_path, "hang.py", """
        import os, time, sys
        if int(os.environ["PTPU_ELASTIC_INCARNATION"]) == 0:
            time.sleep(30)  # hung: never beats
        sys.exit(0)
        """)
    ctrl = ElasticController(script, nproc=1, master=_master(),
                             max_restarts=1,
                             heartbeat_dir=str(tmp_path / "hb"),
                             heartbeat_timeout=1.5, poll_interval=0.05)
    t0 = time.time()
    assert ctrl.run() == 0
    assert ctrl.restarts == 1
    assert time.time() - t0 < 15, "hang must be detected by heartbeat"


def test_permanent_loss_shrinks_and_mid_slot(tmp_path, monkeypatch):
    top = _write(tmp_path, "deadhost.py", """
        import os, sys
        n = int(os.environ["PTPU_NUM_PROCESSES"])
        r = int(os.environ["PTPU_PROCESS_ID"])
        sys.exit(1 if (n == 4 and r == 3) else 0)
        """)
    ctrl = ElasticController(top, nproc=4, master=_master(), max_restarts=4,
                             poll_interval=0.05, np_range=(2, 4),
                             permanent_after=2)
    assert ctrl.run() == 0
    assert ctrl.nproc == 3 and ctrl.resizes == [(2, 4, 3)]
    assert ctrl.restarts == 2
    mid = _write(tmp_path, "midslot.py", """
        import os, sys
        slot = int(os.environ["PTPU_SLOT_ID"])
        n = int(os.environ["PTPU_NUM_PROCESSES"])
        with open(os.environ["ELOG"], "a") as f:
            f.write(f"i{os.environ['PTPU_ELASTIC_INCARNATION']} "
                    f"slot{slot}/{n}\\n")
        sys.exit(1 if slot == 1 else 0)
        """)
    elog = str(tmp_path / "elog.txt")
    monkeypatch.setenv("ELOG", elog)
    ctrl = ElasticController(mid, nproc=4, master=_master(), max_restarts=4,
                             poll_interval=0.05, np_range=(2, 4),
                             permanent_after=2)
    assert ctrl.run() == 0
    assert ctrl.nproc == 3 and ctrl.lost_slots == [1]
    assert ctrl._slots == [0, 2, 3]
    text = open(elog).read()
    assert "i2 slot1/3" not in text and "i2 slot3/3" in text


def test_below_min_np_gives_up(tmp_path):
    script = _write(tmp_path, "alldead.py", "import sys; sys.exit(2)\n")
    ctrl = ElasticController(script, nproc=2, master=_master(),
                             max_restarts=10, poll_interval=0.05,
                             np_range=(2, 2), permanent_after=2)
    assert ctrl.run() == 1
    assert ctrl.nproc == 2
    with pytest.raises(ValueError, match="np_range"):
        ElasticController(script, nproc=5, np_range=(2, 4))


def test_np_request_scale_out(tmp_path, monkeypatch):
    script = _write(tmp_path, "scaled.py", """
        import os, sys, time
        n = int(os.environ["PTPU_NUM_PROCESSES"])
        inc = int(os.environ["PTPU_ELASTIC_INCARNATION"])
        with open(os.environ["ELOG"], "a") as f:
            f.write(f"i{inc} world {n}\\n")
        if inc == 0:
            time.sleep(30)  # runs until the resize stops it
        sys.exit(0)
        """)
    elog = str(tmp_path / "elog.txt")
    ctl = tmp_path / "ctl"
    ctl.mkdir()
    (ctl / "np_request").write_text("3")
    monkeypatch.setenv("ELOG", elog)
    ctrl = ElasticController(script, nproc=1, master=_master(),
                             max_restarts=1, poll_interval=0.05,
                             np_range=(1, 3), control_dir=str(ctl))
    assert ctrl.run() == 0
    assert ctrl.nproc == 3 and ctrl.restarts == 0
    assert ctrl.resizes == [(1, 1, 3)]
    assert not (ctl / "np_request").exists()
    assert open(elog).read().count("world 3") == 3


def test_controller_timeout(tmp_path):
    script = _write(tmp_path, "slow.py", "import time; time.sleep(30)\n")
    t0 = time.time()
    ctrl = ElasticController(script, nproc=2, master=_master(),
                             poll_interval=0.05, timeout=1.0)
    assert ctrl.run() == 124
    assert time.time() - t0 < 15


def test_launch_local_env_failure_and_timeout(tmp_path, monkeypatch):
    env = build_worker_env(1, 2, "127.0.0.1:1234", devices_per_proc=4,
                           extra={"X": "y"})
    assert (env["PTPU_COORDINATOR"], env["PTPU_NUM_PROCESSES"],
            env["PTPU_PROCESS_ID"], env["PTPU_RANKS_PER_PROC"],
            env["X"]) == ("127.0.0.1:1234", "2", "1", "4", "y")
    assert "PTPU_RANKS_PER_PROC" not in build_worker_env(0, 1, "h:1")
    script = _write(tmp_path, "w.py", """
        import os, sys, time
        with open(os.environ["ELOG"] + os.environ["PTPU_PROCESS_ID"],
                  "w") as f:
            f.write(" ".join(os.environ[k] for k in (
                "PTPU_NUM_PROCESSES", "PTPU_RANKS_PER_PROC")) + " "
                + " ".join(sys.argv[1:]))
        if sys.argv[1] == "fail" and os.environ["PTPU_PROCESS_ID"] == "1":
            sys.exit(5)
        if sys.argv[1] != "ok":
            time.sleep(30)
        """)
    elog = str(tmp_path / "w.")
    monkeypatch.setenv("ELOG", elog)
    assert launch_local(script, ["ok", "a"], 2, devices_per_proc=2,
                        timeout=20) == 0
    assert [open(elog + str(r)).read() for r in (0, 1)] == ["2 2 ok a"] * 2
    t0 = time.time()
    assert launch_local(script, ["fail"], 2, devices_per_proc=1,
                        timeout=20) != 0
    assert launch_local(script, ["hang"], 2, devices_per_proc=1,
                        timeout=1.0) == 124
    assert time.time() - t0 < 20


def test_launch_module_starts_the_workers(tmp_path, monkeypatch):
    script = _write(tmp_path, "w.py", """
        import os
        with open(os.environ["ELOG"] + os.environ["PTPU_PROCESS_ID"],
                  "w") as f:
            f.write(os.environ["PTPU_NUM_PROCESSES"] + " "
                    + os.environ["PTPU_RANKS_PER_PROC"] + " "
                    + os.environ["PTPU_COORDINATOR"])
        """)
    elog = str(tmp_path / "w.")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.parallel.launch",
         "--nproc_per_node", "2", "--devices_per_proc", "3", "--timeout",
         "60", script], cwd=repo, env={**os.environ, "ELOG": elog},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = [open(elog + str(r)).read().split() for r in (0, 1)]
    assert got[0][:2] == got[1][:2] == ["2", "3"]
    assert got[0][2] == got[1][2] and got[0][2].startswith("127.0.0.1:")
