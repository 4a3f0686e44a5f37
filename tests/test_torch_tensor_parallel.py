"""Tensor-parallel training over ``torch.distributed``: the model axis's
Megatron split in training (``motiondiffusion_moe_tpu_torch/parallel/
{mesh,moe_parallel}.py``, ``training/{train_state,trainer,checkpoint}.py``),
on the CPU.

Four ranks run as processes over gloo (``tests/_torch_tp_worker.py``, a
``file://`` rendezvous under ``tmp_path``), spawned once per module and
started before the JAX references are computed. The tiny widths of
``tests/_torch_parity.py::tiny_config`` (latent 64, expert hidden 32, 4
experts, the cross-attention MLP 256, one block a scale), f32, dropout 0,
the MoE balance weight, the velocity loss and the EMA on, and the batch of
``test_torch_moe_parallel.py`` (8 rows, ragged lengths, t below 50). Rank
``r = (d ep + e) tp + m``; the two model ranks of a group hold the same
rows, row-holder ``q = r // tp`` rows ``[q B / Q, (q + 1) B / Q)`` of the
batch, ``Q = dp ep = 2``.

Held against the JAX package: one step of the port over the ranks against
the JAX loss, ``jax.grad`` and one ``make_optimizer`` update on the global
batch (``test_torch_moe_parallel.py``'s tolerances: the loss rtol 1e-5,
each gradient within 1e-4 of its largest entry plus 1e-7, the clip's norm
rtol 1e-5, the parameters and the EMA within 2e-6, mu within 1e-5 of its
largest entry) in five cases: the model without MoE (``use_moe`` False:
its ``DenseFFN`` branches cut by JAX's rule) at ``(data 2, model 2)``;
``(data 2, model 2)`` and ``(expert 2, model 2)`` computing ``dense``
(against the one-device ``dense`` model),
``(expert 2, model 2)`` computing ``dispatch`` with ZeRO-1 (against the JAX
model on the ``(data 1, expert 2)`` mesh, whose ``ep_moe_ffn_sharded``
takes the same two chunks), and ``(data 2, model 2)`` computing
``dispatch`` with ZeRO-1 (against the one-device ``dispatch`` model: the
global capacity). The gradient is the one the optimizer clips: reduced
over the ranks and gathered to the global layout.

Two controls miss the gradient tolerance by far: the column inputs'
backward without the model group's sum, and the model-cut leaves reduced
over the world (their column blocks added together) instead of over the
ranks that share their model index.

Also: a ``DenseFFN`` split over the model axis at dropout 0.2 against the
whole module on the same generator (the output and every gradient within
1e-5); each rank holds ``1 / tp`` of every leaf JAX's rule cuts; a ``tp =
2`` save (both formats) is global, resumes at ``tp = 2`` and in one
process, and the JAX manager restores it; the trainer's errors and its
``dense_fused`` switch; ``tools/train.py --tensor_parallel 2`` as two
processes, then a one-process resume.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motiondiffusion_moe_tpu.models.transformer import (
    MotionTransformer as JaxMotionTransformer,
)
from motiondiffusion_moe_tpu.parallel.mesh import make_mesh
from motiondiffusion_moe_tpu.training.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
)
from motiondiffusion_moe_tpu.training.train_state import (
    TrainState as JaxTrainState,
    make_optimizer,
)
from motiondiffusion_moe_tpu_torch.models.bridge import jax_to_state_dict
from motiondiffusion_moe_tpu_torch.models.transformer import (
    MotionTransformer,
)
from motiondiffusion_moe_tpu_torch.parallel.mesh import (
    is_expert_param,
    model_dim,
)
from motiondiffusion_moe_tpu_torch.tools import train as train_cli
from motiondiffusion_moe_tpu_torch.training.checkpoint import (
    CheckpointManager,
)
from motiondiffusion_moe_tpu_torch.training.train_state import (
    create_train_state,
)

from tests._torch_parity import random_params, to_port
from tests.test_torch_moe_parallel import (
    TIGHT,
    _assert_step,
    _batch,
    _config,
    _grad_excess,
    _jax_step,
    _names,
    _spawn,
    _start,
    _trainable,
    _wait,
    _with,
)
from tests.test_torch_parallel import TINY_CLI

W = 4
STEPS = {  # name: (ep, compute, zero1, control, reference)
    "dp2tp2_dense": (1, "dense", False, None, "dense"),
    "dp2tp2_dense_ffn": (1, "dense", False, None, "dense_ffn"),
    "ep2tp2_dense": (2, "dense", False, None, "dense"),
    "ep2tp2_dispatch_zero1": (2, "dispatch", True, None, "dispatch_ep2"),
    "dp2tp2_dispatch_zero1": (1, "dispatch", True, None, "dispatch_global"),
    "control_no_column_sum": (1, "dense", False, "no_column_sum", "dense"),
    "control_world_reduce": (1, "dense", False, "world_reduce", "dense")}
SAVES = ("ep2tp2_dense", "ep2tp2_dispatch_zero1")
DENSE_FFN = ("dp2tp2_dense_ffn",)  # the model without MoE (use_moe False)


def _of(run, name):
    """The run seen from case ``name``: its config and JAX parameters."""
    if name in DENSE_FFN:
        return dict(run, cfg=run["cfg_ffn"], params=run["params_ffn"])
    return run


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks started, the JAX references computed meanwhile, then the
    ranks' results."""
    root = tmp_path_factory.mktemp("tp")
    cfg = _config()
    batch = _batch()
    params = random_params(JaxMotionTransformer(cfg.model), batch["motion"],
                           batch["t"], batch["length"],
                           text_ids=batch["text_ids"])
    torch.save(jax_to_state_dict(params), root / "params.pt")
    cfg_ffn = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, use_moe=False))
    params_ffn = random_params(JaxMotionTransformer(cfg_ffn.model),
                               batch["motion"], batch["t"], batch["length"],
                               text_ids=batch["text_ids"])
    torch.save(jax_to_state_dict(params_ffn), root / "params_ffn.pt")
    np.savez(root / "batch.npz", **batch)
    ffn = {"cfg": to_port(cfg_ffn).to_dict(),
           "state_dict": str(root / "params_ffn.pt")}
    cases = [dict(kind="step", name=n, ep=ep, tp=2, compute=c, zero1=z,
                  cf=TIGHT, control=ctl, save=n in SAVES,
                  **(ffn if n in DENSE_FFN else {}))
             for n, (ep, c, z, ctl, _) in STEPS.items()]
    cases += [dict(kind="ffn", name="ffn", ep=1, tp=2),
              dict(kind="units", name="units", ep=1, tp=2)]
    spec = {"cfg": to_port(cfg).to_dict(), "state_dict": str(
        root / "params.pt"), "batch": str(root / "batch.npz"),
        "init": f"file://{root / 'rdv'}", "world": W, "cases": cases,
        "out": str(root)}
    with open(root / "spec.json", "w") as f:
        json.dump(spec, f)
    job = _start([["-m", "tests._torch_tp_worker", str(root / "spec.json"),
                   str(r)] for r in range(W)])
    refs = {"dense": _jax_step(_with(cfg, "dense"), params, batch),
            "dense_ffn": _jax_step(cfg_ffn, params_ffn, batch),
            "dispatch_global": _jax_step(_with(cfg, "dispatch"), params,
                                         batch),
            "dispatch_ep2": _jax_step(_with(cfg, "dispatch"), params, batch,
                                      make_mesh(2, expert_parallel=2))}
    for rc, out in _wait(job):
        assert rc == 0, out[-4000:]
    got = {c["name"]: torch.load(root / f"{c['name']}.pt",
                                 weights_only=False) for c in cases}
    return dict(cfg=cfg, params=params, batch=batch, got=got, refs=refs,
                root=root, cfg_ffn=cfg_ffn, params_ffn=params_ffn)


# -------------------------------------------------------------- the steps

@pytest.mark.parametrize("name", [n for n, v in STEPS.items()
                                  if v[3] is None])
def test_tensor_parallel_step_matches_jax(run, name):
    _assert_step(_of(run, name), name, run["refs"][STEPS[name][4]])


@pytest.mark.parametrize("name", [n for n, v in STEPS.items()
                                  if v[3] is not None])
def test_controls_miss_the_jax_gradient(run, name):
    """No model-group sum in the column inputs' backward, and the model-cut
    leaves reduced over the world: both miss by far."""
    _, grads = run["refs"][STEPS[name][4]]
    assert _grad_excess(run["got"][name]["grads"], _trainable(grads)) > 10


def test_each_rank_holds_its_share_of_every_cut_leaf(run):
    """1 / tp of every leaf JAX's Megatron rule cuts (and 1 / ep of the
    experts), the cuts read off the modules equal to the rule's; the
    moments and the EMA cut like their weights, and thinner still under
    ZeRO-1."""
    for name, (ep, _, zero1, _, _) in STEPS.items():
        sd = jax_to_state_dict(_of(run, name)["params"])
        want = {n: v for n, v in sd.items() if model_dim(n, v.shape, 2)
                is not None}
        # 12 expert leaves or 12 of the DenseFFN branches (fc1's weight
        # and bias, fc2's weight), 6 of the cross-attention MLP
        assert len(want) == 18, name
        assert any(("branch_0_fc" if name in DENSE_FFN else "_moe.w")
                   in n for n in want), name
        # the rank's elements of the whole model: 1 / tp of a cut leaf,
        # 1 / ep of an expert
        local = sum(v.numel() // (2 if n in want else 1)
                    // (ep if is_expert_param(n) else 1)
                    for n, v in sd.items())
        for held in run["got"][name]["held"]:
            assert set(held["split"]) == set(want), name
            assert set(held["cut_dims"]) == set(want), name
            for n, v in want.items():
                div = 2 * (ep if is_expert_param(n) else 1)
                assert held["split"][n] * div == v.numel(), (name, n)
            if zero1:
                assert held["ema"] < local // 2, (name, held["ema"])
            else:
                assert held["ema"] == local, (name, held["ema"])


def test_a_split_dense_ffn_at_dropout_matches_the_whole_one(run):
    """The column-split ``fc1`` (its input's gradient summed over the
    model group), the dropout drawing the whole width's mask, the
    row-parallel ``fc2`` with its bias's gradient on both model ranks."""
    for got in run["got"]["ffn"]:
        assert got["split"] == ["branch_0_fc1.bias", "branch_0_fc1.weight",
                                "branch_0_fc2.weight", "branch_1_fc1.bias",
                                "branch_1_fc1.weight", "branch_1_fc2.weight"]
        assert got["dropout_moves"] > 1e-2  # the masks are live
        for k, v in got["worst"].items():
            assert v <= 1e-5, (k, v)


# ---------------------------------------------------------- checkpoints

@pytest.mark.parametrize("fmt", ["torch", "orbax"])
@pytest.mark.parametrize("name", SAVES)
def test_a_tp2_save_is_global_and_resumes_at_tp2_and_in_one_process(
        run, name, fmt):
    got = run["got"][name]
    assert got["saved"][fmt] == [True] * W
    root, cfg = run["root"], to_port(run["cfg"])
    path = str(root / f"ckpt_{name}_{fmt}")
    payload = CheckpointManager(path, cfg=cfg).read()
    for n, v in got["params"].items():
        assert torch.equal(payload["params"][n], v.cpu()), n
    model = MotionTransformer(cfg.model)
    state = create_train_state(model, cfg)
    _, epoch, rng = CheckpointManager(path, cfg=cfg).restore_with_rng(state)
    assert state.step == 1 and epoch == 0 and len(rng) == 2
    for a, b in zip(model.state_dict().values(), got["params"].values()):
        assert torch.equal(a, b.cpu())
    for k in ("mu", "nu"):
        for a, b in zip(getattr(state.optimizer, k), got["opt"][k]):
            assert torch.equal(a, b.cpu()), k
    for a, b in zip(state.ema.params, got["ema"]):
        assert torch.equal(a, b.cpu())


def test_the_jax_manager_restores_a_tp2_save(run):
    cfg = run["cfg"]
    b = run["batch"]
    shapes = jax.eval_shape(lambda: JaxMotionTransformer(cfg.model).init(
        jax.random.key(0), b["motion"], b["t"], b["length"],
        text_ids=b["text_ids"]))
    params = jax.tree_util.tree_map(lambda x: jnp.zeros(x.shape, x.dtype),
                                    shapes)
    tx = make_optimizer(cfg)
    template = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                             opt_state=tx.init(params), tx=tx,
                             ema_params={"params": params["params"]})
    jstate, epoch, _ = JaxCheckpointManager(str(
        run["root"] / "ckpt_ep2tp2_dispatch_zero1_orbax")).restore_with_rng(
            template)
    assert int(jstate.step) == 1 and epoch == 0
    got = run["got"]["ep2tp2_dispatch_zero1"]
    sd = jax_to_state_dict(jax.device_get(jstate.params["params"]))
    for n, v in got["params"].items():
        assert torch.equal(sd[n], v.cpu()), n
    names = [n for n in _names(cfg) if "fa_projection" not in n]
    mu = jax_to_state_dict(jax.device_get(
        jstate.opt_state[1][0].mu["params"]))
    for n, v in zip(names, got["opt"]["mu"]):
        assert torch.equal(mu[n], v.cpu()), n
    assert sd["blocks_high.0.ffn.branch_0_moe.w1"].shape == (4, 64, 32)
    assert sd["blocks_high.0.sd_cross_attn.ffn_0.bias"].shape == (256,)


# ------------------------------------------------------------ errors, CLI

@pytest.mark.parametrize("name,kind,words", [
    ("tp_divides", "ValueError", "launch a multiple of 3 processes"),
    ("ep_tp_divide", "ValueError", "launch a multiple of 8 processes"),
    ("data_partitions", "ValueError", "x 2 model partitions"),
    ("microbatch", "ValueError", "not divisible by the 2 data ranks"),
    ("seq", "ValueError", "launch a multiple of 6 processes"),
    ("pipe", "ValueError", "composes with 'data' only; mesh has model=2"),
    ("caller_dense_fused", "ValueError", "expert- or tensor-sharded")])
def test_tensor_parallel_errors(run, name, kind, words):
    err = run["got"]["units"][name]
    assert err is not None and err[0] == kind and words in err[1], err


def test_trainer_builds_the_tp_mesh_and_dense_fused_becomes_dense(run):
    """JAX's ``test_trainer_builds_tp_mesh``: the mesh has the model axis,
    ``dense_fused`` runs as ``dense``; ranks 2q and 2q + 1 are row-holder
    q."""
    units = run["got"]["units"]
    assert units["dense_fused_became"] == "dense"
    assert units["row_holder"] == [(0, 2, 0), (0, 2, 1), (1, 2, 0),
                                   (1, 2, 1)]


def test_train_cli_tensor_parallel_as_two_processes_then_one_resumes(
        tmp_path, capsys):
    ck = str(tmp_path / "runs")
    base = TINY_CLI + ["--checkpoint_dir", ck]
    outs = _spawn([["-m", "motiondiffusion_moe_tpu_torch.tools.train", *base,
                    "--coordinator_address", f"file://{tmp_path / 'rdv'}",
                    "--num_processes", "2", "--process_id", str(r),
                    "--tensor_parallel", "2", "--zero1"] for r in range(2)])
    for rc, out in outs:
        assert rc == 0, out[-4000:]
    assert "loss_total" in outs[0][1] and "loss_total" not in outs[1][1]
    run_dir = os.path.join(ck, "t2m_moe_small")
    ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"))
    assert ckpt.all_steps() == [4]
    payload = ckpt.read()
    assert len(payload["rng"]) == 1  # one row-holder
    w1 = payload["params"]["blocks_high.0.ffn.branch_0_moe.w1"]
    assert w1.shape[2] == 32  # the global layout, the whole hidden width
    state = train_cli.main(base)
    assert "resumed from step 4 (epoch 1)" in capsys.readouterr().out
    for a, b in zip(state.model.state_dict().values(),
                    payload["params"].values()):
        assert torch.equal(a, b)
    for k in ("mu", "nu"):
        for a, b in zip(state.optimizer.state_dict()[k],
                        payload["opt_state"][k]):
            assert torch.equal(a, b)

