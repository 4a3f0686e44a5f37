"""The seq axis in generation (``generation_mesh(..., seq_parallel=sp)``,
JAX's ``(data, seq, expert, model)`` mesh), on the CPU.

Four gloo ranks (``tests/_torch_mesh_worker.py``, a ``file://`` rendezvous
under ``tmp_path``) run every layout in turn, started before the JAX
references are computed. The model is ``tests/test_parallel.py::tiny_cfg``'s
(latent 32, expert hidden 16, 4 experts, one block a scale, 2 heads, m = 8,
f32, ``dense``) with seeded flax weights (every leaf nonzero, the head 100x
smaller), through ``models/bridge.py``.

Held against the JAX package:

- the FAVOR+ split in one process: the moments of 2 and 4 cuts of T
  (uneven, odd T, masks that end inside a cut) summed, then the apply on
  each cut, equal the whole-T plain versions within 1e-6 relative (kernel 1
  and kernel 8's core), and the wrappers take the plain versions on the
  CPU;
- the T-cut forward of every listed layout, gathered, against the JAX
  ``MotionTransformer`` on one device within JAX's own ``atol 2e-5, rtol
  1e-5`` (``tests/test_seq_parallel.py::test_forward_matches_single_device``):
  data 2 x seq 2 at T = 15 (the odd frame on the last rank), seq 4 at T =
  14 (cut 4 / 4 / 4 / 2), seq 2 x expert 2 (``dense``), seq 2 x model 2, all
  with lengths below T that end inside other ranks' frames;
- ``dispatch`` with drops (capacity factor 1) at seq 2 x expert 2 against
  the JAX forward on its own seq mesh (``make_mesh(4, seq_parallel=2,
  expert_parallel=2)``): JAX's chunks of the flattened tokens of whole T,
  so JAX's drops; the one-device JAX forward (the global capacity) misses
  that reference by more than 10x the tolerance, so the drops are felt;
- ``GenerationPipeline`` on seq 2 x expert 2 and on data 2 x seq 2, DDIM 10
  steps on injected noise, against the JAX sampler on one device within
  JAX's atol 2e-4 (``::test_pipeline_seq_mesh_matches_single_device``);
- the rank numbering: ``ExpertMesh.rank_of`` against the device order of
  JAX ``make_mesh(8, seq_parallel=2, expert_parallel=2)``, and each rank's
  indices on the four ranks' mesh against ``make_mesh(4, ...)``'s;
- the frames a seq rank holds (``ExpertMesh.frames``) and the errors: T <
  2 sp, a world that is not data x seq x expert x model, two seq partitions
  in one process; the training layout and the split under grad run
  (training over seq: ``tests/test_torch_seq_training.py``).
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motiondiffusion_moe_tpu.diffusion import (
    ddim_sample_loop as jax_ddim_loop,
    make_schedule as jax_make_schedule,
    respace_schedule as jax_respace,
    space_timesteps as jax_space,
)
from motiondiffusion_moe_tpu.models.transformer import (
    MotionTransformer as JaxMotionTransformer,
)
from motiondiffusion_moe_tpu.parallel import make_mesh, param_shardings
from motiondiffusion_moe_tpu_torch.models.bridge import jax_to_state_dict
from motiondiffusion_moe_tpu_torch.models.text_encoder import hash_tokenize
from motiondiffusion_moe_tpu_torch.ops import performer as PF
from motiondiffusion_moe_tpu_torch.parallel.mesh import (
    ExpertMesh,
    generation_mesh,
)

from tests._torch_parity import random_params, tiny_config, to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 4
MB, STEPS, CF = 4, 10, 1.0
PROMPTS = ["a person walks forward", "jump", "", "turns and waves"]
LENGTHS = [16, 9, 1, 12]
FWD = {"t15": (15, [15, 9, 4, 1]), "t14": (14, [14, 13, 5, 2])}
ATOL, RTOL = 2e-5, 1e-5   # JAX's test_forward_matches_single_device
PIPE_ATOL = 2e-4          # JAX's test_pipeline_seq_mesh_matches_single_device
SPLIT_REL = 1e-6
DISPATCH = {"moe_compute": "dispatch", "moe_capacity_factor": CF}

CASES = [  # name, kind, layout (dp, ep, tp, sp), model fields, extra
    ("dp2_sp2_t15", "forward", (2, 1, 1, 2), {}, {"prefix": "t15"}),
    ("sp4_t14", "forward", (1, 1, 1, 4), {"moe_compute": "dense_fused"},
     {"prefix": "t14"}),
    ("sp2_ep2_t14", "forward", (1, 2, 1, 2), {}, {"prefix": "t14"}),
    ("sp2_tp2_t15", "forward", (1, 1, 2, 2), {}, {"prefix": "t15"}),
    ("sp2_ep2_dispatch", "forward", (1, 2, 1, 2), DISPATCH,
     {"prefix": "t14"}),
    ("sp4_grad", "forward", (1, 1, 1, 4), {},
     {"prefix": "t14", "control": "grad"}),
    ("sp2_ep2_sample", "sample", (1, 2, 1, 2), {}, {"steps": STEPS}),
    ("dp2_sp2_sample", "sample", (2, 1, 1, 2), {}, {"steps": STEPS}),
    ("seq_units", "seq_units", (1, 2, 1, 2), {}, {}),
]
FORWARDS = {  # case: its JAX reference
    "dp2_sp2_t15": "t15", "sp4_t14": "t14", "sp2_ep2_t14": "t14",
    "sp2_tp2_t15": "t15", "sp2_ep2_dispatch": "dispatch_mesh"}


def _cfg(**model):
    base = dict(num_layers=1, latent_dim=32, ff_size=16,
                num_random_features=8, text_max_tokens=8,
                moe_compute="dense")
    return tiny_config("float32", **dict(base, **model))


def _inputs(cfg):
    m = cfg.model
    rng = np.random.default_rng(11)
    a = {"ids_c": hash_tokenize(PROMPTS, m.text_max_tokens),
         "ids_u": hash_tokenize([""] * MB, m.text_max_tokens),
         "lengths": np.asarray(LENGTHS, np.int64),
         "noise": rng.standard_normal((MB, m.max_frames, m.input_feats)
                                      ).astype(np.float32)}
    for prefix, (T, lengths) in FWD.items():
        a[f"{prefix}_x"] = rng.standard_normal(
            (MB, T, m.input_feats)).astype(np.float32)
        a[f"{prefix}_t"] = np.asarray([3, 40, 77, 99], np.int64)
        a[f"{prefix}_length"] = np.asarray(lengths, np.int64)
        a[f"{prefix}_ids"] = a["ids_c"]
    return a


def _flax_params(cfg, a):
    T = cfg.model.max_frames
    params = random_params(JaxMotionTransformer(cfg.model), a["noise"],
                           np.zeros(MB, np.int32), np.full(MB, T, np.int32),
                           text_ids=a["ids_c"])
    # the head 100x smaller (forward outputs ~0.05), so that the sampler's
    # own amplification (guidance 7.5, the division by sqrt(abar); samples
    # reach ~300) keeps f32 summation orders under JAX's absolute 2e-4. At
    # 10x smaller (outputs ~0.5) one element of 1664 of the 10-step guided
    # trajectory lands at 2.4e-4 (1.8e-6 relative) between two orders
    params["out"] = {k: 0.01 * v for k, v in params["out"].items()}
    return params


def _start(root, spec):
    spec = dict(spec, init=f"file://{root / 'rdv'}", world=W, out=str(root),
                cases=[dict(name=n, kind=k, layout=lay, model=m, **extra)
                       for n, k, lay, m, extra in CASES])
    path = root / "job.json"
    path.write_text(json.dumps(spec))
    env = {k: v for k, v in os.environ.items() if k != "PYTEST_CURRENT_TEST"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, "-m", "tests._torch_mesh_worker",
                              str(path), str(r)], cwd=REPO, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for r in range(W)]


def _wait(procs, timeout=300):
    deadline = time.monotonic() + timeout
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append((p.returncode, out))
    return outs


def _jax_forward(cfg, params, a, prefix, mesh=None):
    model = JaxMotionTransformer(cfg.model, mesh=mesh)
    args = [jnp.asarray(a[f"{prefix}_{k}"]) for k in ("x", "t", "length")]
    ids = jnp.asarray(a[f"{prefix}_ids"])

    def fn(variables, x, t, length):
        return model.apply(variables, x, t, length, text_ids=ids,
                           mutable=["moe_losses", "moe_metrics"])[0]

    variables = {"params": params}
    if mesh is None:
        return np.asarray(jax.jit(fn)(variables, *args))
    shard = param_shardings(variables, mesh)
    with mesh:
        return np.asarray(jax.jit(fn)(jax.device_put(variables, shard),
                                      *args))


def _jax_sample(cfg, params, a):
    """The JAX sampler on one device as ``GenerationPipeline._sample_fn``
    builds it, the noise injected."""
    model = JaxMotionTransformer(cfg.model)
    d = cfg.diffusion
    base = jax_make_schedule(schedule_name=d.beta_schedule,
                             num_timesteps=d.num_timesteps)
    sched, tmap = jax_respace(np.asarray(base.betas, np.float64),
                              jax_space(d.num_timesteps, f"ddim{STEPS}"))
    ids_c, ids_u = jnp.asarray(a["ids_c"]), jnp.asarray(a["ids_u"])
    lengths = jnp.asarray(a["lengths"], jnp.int32)

    def fn(variables, noise, key):
        enc_c = model.apply(variables, ids_c,
                            method=lambda m, i: m.encode_text(i))
        enc_u = model.apply(variables, ids_u,
                            method=lambda m, i: m.encode_text(i))
        xf_proj = jnp.concatenate([enc_c.pooled, enc_u.pooled])
        xf_out = jnp.concatenate([enc_c.tokens, enc_u.tokens])
        length2 = jnp.concatenate([lengths, lengths])

        def model_doubled(x2, t2):
            return model.apply(variables, x2, t2, length2, xf_proj=xf_proj,
                               xf_out=xf_out,
                               mutable=["moe_losses", "moe_metrics"])[0]

        return jax_ddim_loop(sched, model_doubled, noise, key,
                             guidance_scale=d.cfg_scale, timestep_map=tmap)

    return np.asarray(jax.jit(fn)({"params": params}, jnp.asarray(a["noise"]),
                                  jax.random.key(3)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks started, the JAX references computed meanwhile, then the
    ranks' results."""
    root = tmp_path_factory.mktemp("seq")
    cfg = _cfg()
    a = _inputs(cfg)
    np.savez(root / "inputs.npz", **a)
    params = _flax_params(cfg, a)
    torch.save(jax_to_state_dict(params), root / "moe.pt")
    procs = _start(root, {"cfg": to_port(cfg).to_dict(),
                          "weights": {"moe": str(root / "moe.pt")},
                          "inputs": str(root / "inputs.npz"), "steps": STEPS,
                          "micro_batch": MB})

    refs = {p: _jax_forward(cfg, params, a, p) for p in FWD}
    dcfg = _cfg(**DISPATCH)
    refs["dispatch_mesh"] = _jax_forward(
        dcfg, params, a, "t14",
        make_mesh(4, seq_parallel=2, expert_parallel=2))
    refs["dispatch_one"] = _jax_forward(dcfg, params, a, "t14")
    refs["sample"] = _jax_sample(cfg, params, a)

    outs = _wait(procs)
    for rc, out in outs:
        assert rc == 0, out[-4000:]
    got = {n: torch.load(root / f"{n}.pt", weights_only=False)
           for n, *_ in CASES}
    return dict(refs=refs, got=got)


# ------------------------------------------------ the split, one process

def _split_case(T, cuts, seed):
    g = torch.Generator().manual_seed(seed)
    B, H, D, m = 3, 2, 16, 8
    qkv = torch.randn(B, T, 3 * H * D, generator=g)
    ln = (1 + 0.1 * torch.randn(D, generator=g), 0.1 * torch.randn(
        D, generator=g), torch.randn(D, m, generator=g) * D ** -0.25)
    # lengths ending inside the cuts; one row all but masked out
    mask = (torch.arange(T)[None] < torch.tensor(
        [T, T // 2 + 1, 1])[:, None]).float()
    return qkv, ln, mask, [(cuts[i], cuts[i + 1])
                           for i in range(len(cuts) - 1)]


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("T,cuts", [(14, [0, 8, 14]), (15, [0, 8, 15]),
                                    (14, [0, 4, 8, 12, 14]),
                                    (15, [0, 4, 8, 12, 15])])
def test_split_sums_to_the_whole_kernel_1(T, cuts):
    qkv, ln, mask, parts = _split_case(T, cuts, T + len(cuts))
    whole = PF.favor_qkv_plain(qkv, *ln, mask)
    kv = sum(PF.favor_qkv_moments_plain(qkv[:, a:b], *ln, mask[:, a:b])
             for a, b in parts)
    out = torch.cat([PF.favor_qkv_apply_plain(qkv[:, a:b], kv, *ln,
                                              mask[:, a:b])
                     for a, b in parts], 1)
    assert _rel(out, whole) <= SPLIT_REL
    # on the CPU the wrappers take the plain versions
    with torch.no_grad():
        a, b = parts[-1]
        assert torch.equal(PF.favor_qkv_moments(qkv[:, a:b], *ln,
                                                mask[:, a:b]),
                           PF.favor_qkv_moments_plain(qkv[:, a:b], *ln,
                                                      mask[:, a:b]))
        assert torch.equal(PF.favor_qkv_apply(qkv[:, a:b], kv, *ln,
                                              mask[:, a:b]), out[:, a:b])


@pytest.mark.parametrize("T,cuts", [(15, [0, 8, 15]),
                                    (14, [0, 4, 8, 12, 14])])
def test_split_sums_to_the_whole_kernel_8(T, cuts):
    qkv, (_, _, proj), mask, parts = _split_case(T, cuts, 3 * T)
    B, H, D = qkv.shape[0], 2, proj.shape[0]
    q, k, v = (x.reshape(B, T, H, D).transpose(1, 2).contiguous()
               for x in qkv.split(H * D, -1))
    m3 = mask[:, None]
    whole = PF.favor_attention_plain(q, k, v, proj, m3)
    with torch.no_grad():
        kv = sum(PF.favor_attention_moments(k[:, :, a:b], v[:, :, a:b], proj,
                                            m3[..., a:b]) for a, b in parts)
        out = torch.cat([PF.favor_attention_apply(
            q[:, :, a:b], k[:, :, a:b], kv, proj, m3[..., a:b])
            for a, b in parts], 2)
    assert _rel(out, whole) <= SPLIT_REL


def test_split_raises_under_grad():
    """Under grad the split no longer raises: the moments and the apply
    are the steps of the differentiable ``favor_qkv_split``, whose
    gradient on one seq rank (a group whose sum is the identity) is
    ``favor_qkv``'s (the seq ranks' training,
    tests/test_torch_seq_training.py)."""
    qkv, ln, mask, _ = _split_case(8, [0, 8], 1)
    one = SimpleNamespace(sum_=lambda t: t)
    grads = []
    for fn in (lambda x: PF.favor_qkv(x, *ln, mask),
               lambda x: PF.favor_qkv_split(x, *ln, mask, one)):
        x = qkv.clone().requires_grad_()
        fn(x).sum().backward()
        grads.append(x.grad)
    assert _rel(grads[1], grads[0]) <= SPLIT_REL
    x = qkv.clone().requires_grad_()
    kv = PF.favor_qkv_moments(x, *ln, mask)
    assert _rel(PF.favor_qkv_apply(x, kv, *ln, mask).detach(),
                PF.favor_qkv_plain(qkv, *ln, mask)) <= SPLIT_REL


# ------------------------------------------------ the frames, the numbering

@pytest.mark.parametrize("T,sp,sizes", [
    (196, 4, [50, 50, 48, 48]), (14, 4, [4, 4, 4, 2]), (15, 2, [8, 7]),
    (15, 4, [4, 4, 4, 3]), (16, 2, [8, 8]), (8, 4, [2, 2, 2, 2])])
def test_frames_cut_on_even_frames(T, sp, sizes):
    mesh = SimpleNamespace(sp=sp, s=0)
    got = [ExpertMesh.frames(mesh, T, s) for s in range(sp)]
    assert [b - a for a, b in got] == sizes
    assert got[0][0] == 0 and got[-1][1] == T
    assert all(a % 2 == 0 and a == prev for (a, _), (_, prev)
               in zip(got[1:], got))


@pytest.mark.parametrize("T,sp", [(7, 4), (3, 2), (1, 2)])
def test_too_few_frames_raise(T, sp):
    with pytest.raises(ValueError, match=f"{T} frames over {sp} seq"):
        ExpertMesh.frames(SimpleNamespace(sp=sp, s=0), T)


def test_rank_of_is_jax_device_order():
    mesh = make_mesh(8, seq_parallel=2, expert_parallel=2)
    assert mesh.axis_names == ("data", "seq", "expert", "model")
    ns = SimpleNamespace(sp=2, ep=2, tp=1)
    for (d, s, e, m), device in np.ndenumerate(mesh.devices):
        assert ExpertMesh.rank_of(ns, d, e, m, s) == device.id


def test_each_rank_sits_where_jax_puts_its_device(run):
    mesh = make_mesh(4, seq_parallel=2, expert_parallel=2)
    where = {device.id: idx for idx, device in np.ndenumerate(mesh.devices)}
    for r, units in enumerate(run["got"]["seq_units"]):
        d, s, e, m = where[r]
        assert tuple(units["index"]) == (d, s, e, m)


# ------------------------------------------------ the ranks against JAX

@pytest.mark.parametrize("name", sorted(FORWARDS))
def test_t_cut_forward_matches_jax(run, name):
    out = run["got"][name]["out"].numpy()
    ref = run["refs"][FORWARDS[name]]
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_dispatch_under_seq_drops_jax_tokens(run):
    """The dispatch reference is JAX's seq mesh; the one-device JAX forward
    (the global capacity) misses it by far, so the case's drops decide."""
    refs = run["refs"]
    assert np.abs(refs["dispatch_one"] - refs["dispatch_mesh"]).max() \
        > 10 * ATOL
    assert run["got"]["sp2_ep2_dispatch"]["computes"] == ["dispatch"]


@pytest.mark.parametrize("name", ["sp2_ep2_sample", "dp2_sp2_sample"])
def test_pipeline_over_seq_matches_jax(run, name):
    out = run["got"][name]["out"].numpy()
    np.testing.assert_allclose(out, run["refs"]["sample"], atol=PIPE_ATOL)


def test_seq_errors(run):
    """The errors of the seq axis; the training layout and a forward under
    grad run (training over seq, tests/test_torch_seq_training.py)."""
    units = run["got"]["seq_units"][0]
    assert units["training_layout"] == "no error"
    assert "but the process group has 4" in units["world"]
    assert "3 frames over 2 seq partitions" in units["short"]
    assert run["got"]["sp4_grad"]["grad"] == "no error"


def test_seq_in_one_process_and_training_raise():
    """Two seq partitions in one process: generation and training raise
    (a mismatch; the seq ranks train over several,
    tests/test_torch_seq_training.py)."""
    from motiondiffusion_moe_tpu_torch.training.trainer import Trainer

    with pytest.raises(ValueError, match="one process per device"):
        generation_mesh(1, 1, 1, 2)
    cfg = to_port(_cfg())
    cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, num_seq_partitions=2))
    with pytest.raises(ValueError, match="launch a multiple of 2"):
        Trainer(cfg, device="cpu")
