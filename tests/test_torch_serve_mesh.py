"""The serve and evaluate CLIs over ranks, on the CPU.

A tiny run trained by the port's ``tools/train.py`` (as
``test_torch_evaluate_cli.py`` trains it) and its export
(``tools/export.py``) are served by ``tools/serve.py`` as four processes
(``--data_parallel 2 --tensor_parallel 2``, gloo, a ``file://``
rendezvous) and evaluated by ``tools/evaluate.py`` as two
(``--data_parallel 2``), both started before the one-process runs they are
held to:

- a single-prompt request and one of three prompts (two micro-batches of
  2), each with a seed, equal to the one-process server's answer within
  1e-3 of its largest value (``SERVE_REL``; DDPM on a 3-step respacing:
  the step noise drawn on every rank from the same generator); a request
  without a seed
  goes through the batcher; ``/healthz`` is rank 0's; SIGTERM to rank 0
  stops every rank, each exiting 0;
- the evaluation's metrics per replication equal the one-process run's
  within 1e-4 relative (``--device_embeddings`` takes the host path under
  a mesh, with the JAX CLI's warning).

The failure paths, each as two serving ranks (``--data_parallel 2``) that
join a group with a 15 s timeout and rank 0's idle ping every 1 s
(``SERVE_RANK`` sets both): a rank killed while idle makes rank 0 exit
non-zero; ranks idle past the timeout still answer a request while the
pings run, and without them the idle rank times out with an error.
``in_turn`` takes the same turns on every rank when the ranks' memory
readings differ.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from motiondiffusion_moe_tpu_torch.tools.evaluate import main as eval_main
from motiondiffusion_moe_tpu_torch.tools.export import export_run
from motiondiffusion_moe_tpu_torch.tools.serve import build_server
from motiondiffusion_moe_tpu_torch.tools.train import main as train_main

from tests.test_torch_evaluate_cli import FIXTURE_GLOVE, TINY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE = ["--device", "cpu", "--sampler", "ddpm", "--steps", "3",
         "--micro_batch", "2", "--no_denormalize"]
REQUESTS = [{"texts": ["a person walks"], "lengths": [16], "seed": 3},
            {"texts": ["jump", "turn left", "wave"], "lengths": [9, 16, 5],
             "seed": 4}]
# the model axis sums the FFN products in another order; the tiny run's
# 3-step DDPM (x0 from eps at the 50-step schedule's large t) carries that
# to ~2e-4 of the largest value (the data axis alone: bit for bit)
SERVE_REL = 1e-3
EVAL = ["--device", "cpu", "--batch_size", "4", "--sampler", "ddim",
        "--steps", "3", "--dataset", "synthetic", "--max_samples", "8",
        "--replication_times", "1", "--mm_num_samples", "4",
        "--mm_num_repeats", "3", "--mm_num_times", "2",
        "--diversity_times", "4", "--protocol_batch_size", "4",
        "--glove_dir", FIXTURE_GLOVE, "--score_samples", "4"]
EVAL_RANK = ("import sys, torch; from motiondiffusion_moe_tpu_torch.tools."
             "evaluate import main; r = main(sys.argv[2:]); "
             "r is not None and torch.save(r, sys.argv[1])")
# a serving rank: HEARTBEAT INIT WORLD RANK, then the serve CLI's argv; it
# joins the group with a GROUP_TIMEOUT_S timeout before the CLI's main
SERVE_RANK = ("import sys; from motiondiffusion_moe_tpu_torch.parallel "
              "import distributed as D; from motiondiffusion_moe_tpu_torch."
              "tools import serve; D.HEARTBEAT_S = float(sys.argv[1]); "
              "D.initialize_distributed(sys.argv[2], int(sys.argv[3]), "
              "int(sys.argv[4]), backend='gloo', device='cpu', "
              "timeout_s={timeout}); serve.main(sys.argv[5:])")
GROUP_TIMEOUT_S = 15.0
IDLE_S = 20.0  # past the group's timeout
# a rank of the in_turn check: INIT WORLD RANK LOG; its memory reading
# lets rank r load r + 1 copies at once, and each turn is logged
IN_TURN_RANK = r"""
import sys, time
from motiondiffusion_moe_tpu_torch.parallel import distributed as D
init, world, rank, log = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    sys.argv[4]
D.initialize_distributed(init, world, rank, backend="gloo", device="cpu",
                         timeout_s=20)
D.loads_at_once = lambda nbytes: rank + 1

def load():
    with open(log, "a") as fh:
        fh.write(f"start {rank}\n")
    time.sleep(0.3)
    with open(log, "a") as fh:
        fh.write(f"end {rank}\n")
    return rank

assert D.in_turn(load, 1) == rank
assert D.all_gather_objects(rank) == list(range(world))
D.barrier()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(argvs):
    env = {k: v for k, v in os.environ.items() if k != "PYTEST_CURRENT_TEST"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, *argv], cwd=REPO, env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for argv in argvs]


def _launch(root, tag, world, r):
    return ["--coordinator_address", f"file://{root / f'rdv_{tag}'}",
            "--num_processes", str(world), "--process_id", str(r)]


def _post(url, payload, timeout=120):
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url, timeout=5):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _one_process_answers(export_dir):
    import threading

    server = build_server(["--export_dir", export_dir, "--port", "0"]
                          + SERVE)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        return [_post(f"{url}/generate", r) for r in REQUESTS]
    finally:
        server.shutdown()
        server.server_close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four serving ranks and the two evaluating ranks started, the
    one-process answers computed meanwhile; then the requests, the
    shutdown and every rank's exit."""
    root = tmp_path_factory.mktemp("serve_mesh")
    train_main(TINY + ["--name", "meshrun", "--dataset", "synthetic",
                       "--synthetic_size", "8", "--checkpoint_dir",
                       str(root)])
    run_dir = str(root / "meshrun")
    export_dir = export_run(run_dir, str(root / "export"))
    port = _free_port()
    serving = _ranks([["-m", "motiondiffusion_moe_tpu_torch.tools.serve",
                       "--export_dir", export_dir, "--port", str(port),
                       *SERVE, "--data_parallel", "2", "--tensor_parallel",
                       "2", *_launch(root, "serve", 4, r)]
                      for r in range(4)])
    evaluating = _ranks([["-c", EVAL_RANK, str(root / "eval_mesh.pt"),
                          *EVAL, "--run_dir", run_dir, "--log_file",
                          str(root / "mesh.log"), "--device_embeddings",
                          "--data_parallel", "2",
                          *_launch(root, "eval", 2, r)] for r in range(2)])
    one = _one_process_answers(export_dir)
    one_eval = eval_main(EVAL + ["--run_dir", run_dir, "--log_file",
                                 str(root / "one.log")])

    url = f"http://127.0.0.1:{port}"
    deadline = time.monotonic() + 180
    health = None
    while health is None:
        try:
            health = _get(f"{url}/healthz")
        except OSError:
            assert serving[0].poll() is None, serving[0].communicate()[0]
            assert time.monotonic() < deadline, "the server did not start"
            time.sleep(0.5)
    answers = [_post(f"{url}/generate", r) for r in REQUESTS]
    seedless = _post(f"{url}/generate", {"texts": ["run", "sit"],
                                         "lengths": [12, 16]})
    serving[0].send_signal(signal.SIGTERM)
    stopped = time.monotonic()
    outs = []
    for p in serving + evaluating:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append((p.returncode, out))
    return dict(one=one, answers=answers, seedless=seedless, health=health,
                export_dir=export_dir, root=root,
                serve_outs=outs[:4], eval_outs=outs[4:],
                stop_s=time.monotonic() - stopped, one_eval=one_eval,
                mesh_eval=torch.load(root / "eval_mesh.pt",
                                     weights_only=False)
                if os.path.exists(root / "eval_mesh.pt") else None)


@pytest.mark.parametrize("i", range(len(REQUESTS)))
def test_seeded_requests_match_the_one_process_server(runs, i):
    got, one = runs["answers"][i], runs["one"][i]
    assert got["shapes"] == one["shapes"] == [
        [n, 263] for n in REQUESTS[i]["lengths"]]
    for a, b in zip(got["motions"], one["motions"]):
        a, b = np.asarray(a), np.asarray(b)
        assert np.abs(a - b).max() <= SERVE_REL * np.abs(b).max()


def test_a_seedless_request_goes_through_the_batcher(runs):
    got = runs["seedless"]
    assert got["shapes"] == [[12, 263], [16, 263]] and got["batched"] == 2
    assert all(np.isfinite(np.asarray(m)).all() for m in got["motions"])


def test_healthz_is_rank_zeros(runs):
    health = runs["health"]
    assert health["ok"] and health["micro_batch"] == 2
    assert health["sampler"] == "ddpm" and health["device"] == "cpu"


def test_sigterm_to_rank_zero_stops_every_rank(runs):
    for r, (rc, out) in enumerate(runs["serve_outs"]):
        assert rc == 0, out[-3000:]
        if r:
            assert "stopped by rank 0" in out
    assert "shutting down" in runs["serve_outs"][0][1]
    assert runs["stop_s"] < 60


def test_evaluate_over_two_data_ranks_matches_one_process(runs):
    for rc, out in runs["eval_outs"]:
        assert rc == 0, out[-3000:]
    assert "--device_embeddings unsupported under a mesh" in \
        runs["eval_outs"][0][1]
    got, one = runs["mesh_eval"], runs["one_eval"]
    for key, per_model in one["per_replication"].items():
        for model, values in per_model.items():
            np.testing.assert_allclose(got["per_replication"][key][model],
                                       values, rtol=1e-4, atol=1e-6)
    for a, b in zip(got["joint"], one["joint"]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def _wait_up(url, procs, deadline):
    while True:
        try:
            return _get(f"{url}/healthz")
        except OSError:
            assert all(p.poll() is None for p in procs), \
                [p.communicate()[0][-3000:] for p in procs]
            assert time.monotonic() < deadline, "the server did not start"
            time.sleep(0.3)


def _exit(p, timeout):
    """(returncode, output) of ``p`` once it exits, or (None, output) when
    it is still running ``timeout`` s on (then killed)."""
    try:
        out, _ = p.communicate(timeout=timeout)
        return p.returncode, out
    except subprocess.TimeoutExpired:
        p.kill()
        return None, p.communicate()[0]


@pytest.fixture(scope="module")
def failures(runs):
    """Three pairs of serving ranks at once (see the module doc): "kill"
    (rank 1 killed once rank 0 is up), "pinged" (idle IDLE_S, then
    REQUESTS[0], then SIGTERM) and "silent" (no ping within IDLE_S, then
    the same request)."""
    root = runs["root"]
    launcher = SERVE_RANK.format(timeout=GROUP_TIMEOUT_S)
    beats = {"kill": 1.0, "pinged": 1.0, "silent": 1e6}
    ports = {name: _free_port() for name in beats}
    pairs = {name: _ranks([["-c", launcher, str(beat),
                            f"file://{root / f'rdv_fail_{name}'}", "2",
                            str(r), "--export_dir", runs["export_dir"],
                            "--port", str(ports[name]), *SERVE,
                            "--data_parallel", "2"] for r in range(2)])
             for name, beat in beats.items()}
    deadline = time.monotonic() + 180
    urls = {name: f"http://127.0.0.1:{port}" for name, port in ports.items()}
    for name in beats:
        _wait_up(urls[name], pairs[name], deadline)
    res = {}
    pairs["kill"][1].kill()
    killed = time.monotonic()
    res["kill"] = _exit(pairs["kill"][0], 60)
    res["kill_s"] = time.monotonic() - killed
    time.sleep(max(0.0, IDLE_S - (time.monotonic() - killed)))
    res["silent_rank1"] = _exit(pairs["silent"][1], 30)
    for name in ("pinged", "silent"):
        try:
            res[name + "_answer"] = _post(f"{urls[name]}/generate",
                                          REQUESTS[0], timeout=60)
        except OSError as e:  # the front end stops: no answer
            res[name + "_answer"] = e
    pairs["pinged"][0].send_signal(signal.SIGTERM)
    res["pinged"] = [_exit(p, 60) for p in pairs["pinged"]]
    res["silent_rank0"] = _exit(pairs["silent"][0], 60)
    for p in pairs["kill"][1:]:
        p.communicate()
    return res


def test_a_killed_rank_makes_rank_zero_exit_nonzero(failures):
    rc, out = failures["kill"]
    assert rc not in (None, 0), out[-3000:]
    assert "a rank failed" in out
    assert failures["kill_s"] < 30


def test_pings_keep_idle_ranks_inside_the_group_timeout(failures, runs):
    got, one = failures["pinged_answer"], runs["one"][0]
    assert isinstance(got, dict), got
    for a, b in zip(got["motions"], one["motions"]):
        a, b = np.asarray(a), np.asarray(b)
        assert np.abs(a - b).max() <= SERVE_REL * np.abs(b).max()
    for rc, out in failures["pinged"]:
        assert rc == 0, out[-3000:]


def test_without_pings_an_idle_rank_times_out(failures):
    rc, out = failures["silent_rank1"]
    assert rc not in (None, 0), out[-3000:]
    assert not isinstance(failures["silent_answer"], dict)
    rc, out = failures["silent_rank0"]
    assert rc not in (None, 0), out[-3000:]
    assert "a rank failed" in out


def test_in_turn_takes_the_same_turns_on_every_rank(tmp_path):
    world, log = 3, tmp_path / "turns.log"
    procs = _ranks([["-c", IN_TURN_RANK, f"file://{tmp_path / 'rdv'}",
                     str(world), str(r), str(log)] for r in range(world)])
    for p in procs:
        rc, out = _exit(p, 90)
        assert rc == 0, out[-3000:]
    # the least reading (rank 0's: one at a time) sets every rank's turns
    assert log.read_text().split("\n")[:-1] == [
        f"{what} {r}" for r in range(world) for what in ("start", "end")]
