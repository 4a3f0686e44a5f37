"""The port's feature extraction (``motion/process.py``) and dataset
preparation (``tools/prepare_data.py``) against the JAX package's, on the
CPU, on the same clips: the committed reference clip of
``tests/fixtures/process_goldens.npz`` and seeded synthetic t2m and KIT
clips (forward kinematics of smooth rotations over a drifting root).

Tolerances: the features are f32 chains of IK (qbetween -> qmul -> qrot
over up to 22 joints) in both packages, in the same order of operations,
where XLA and PyTorch differ in the last bits of sqrt and of fused products
-> atol 1e-4 (the JAX package's own CPU run agrees with the reference's
torch goldens to 2e-3). The foot contacts are thresholds on the squared
foot velocity: they are held EQUAL, on clips whose velocities stay away
from the threshold (checked here). The statistics (Mean / Std and meta/)
are sums of those features over every frame -> rtol 1e-5, with an absolute
floor of 1e-5, the features' own error, for channels whose mean or std is
near zero.
"""

import os

import numpy as np
import pytest
import torch

from motiondiffusion_moe_tpu.motion import process as JP
from motiondiffusion_moe_tpu.tools import prepare_data as JPD
from motiondiffusion_moe_tpu_torch.motion import process as TP
from motiondiffusion_moe_tpu_torch.motion.skeleton import Skeleton
from motiondiffusion_moe_tpu_torch.tools import prepare_data as TPD

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures",
                        "process_goldens.npz")
ATOL = 1e-4


def synthesize(cfg, T, seed, bone=0.3, drift=(0.5, 1.0)):
    """Joints [T, J, 3] of one smooth clip: a rest pose with every bone
    ``bone`` long (the collar bones 5/3 as long, so that the shoulders are
    wider than the hips and the facing IK takes from them is defined), a
    seeded pose of its own, small seeded rotations that drift over time,
    and a root that walks ``drift`` (x, z) over the clip."""
    rng = np.random.default_rng(seed)
    J = len(cfg.raw_offsets)
    rest = np.zeros((J, 3), np.float32)
    for chain in cfg.kinematic_chain:
        for a, b in zip(chain[:-1], chain[1:]):
            wide = a != 0 and cfg.raw_offsets[b][0] != 0
            rest[b] = rest[a] + bone * (5 / 3 if wide else 1) * \
                cfg.raw_offsets[b]
    skel = Skeleton(cfg.raw_offsets, cfg.kinematic_chain)
    skel.get_offsets_joints(torch.from_numpy(rest))
    angles = (np.cumsum(rng.standard_normal((T, J, 3)) * 0.02, axis=0)
              + 0.1 * rng.standard_normal((J, 3)))
    quat = np.concatenate([np.cos(np.linalg.norm(angles, axis=-1,
                                                 keepdims=True) / 2),
                           angles * 0.5], axis=-1)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    root = np.stack([np.linspace(0, drift[0], T),
                     np.full(T, 3 * bone) + 0.01 * rng.standard_normal(T),
                     np.linspace(0, drift[1], T)], axis=-1)
    return skel.forward_kinematics(
        torch.from_numpy(quat.astype(np.float32)),
        torch.from_numpy(root.astype(np.float32))).numpy()


def _margin(positions, cfg):
    """Smallest relative distance of a squared foot velocity from the
    contact threshold."""
    feet = list(cfg.fid_l) + list(cfg.fid_r)
    d = positions[1:, feet] - positions[:-1, feet]
    return np.abs((d ** 2).sum(-1) / cfg.feet_thre - 1.0).min()


def _assert_features(port, ref):
    assert port.shape == ref.shape
    np.testing.assert_array_equal(port[:, -4:], ref[:, -4:])
    np.testing.assert_allclose(port, ref, atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def golden():
    return np.load(FIXTURES)


@pytest.fixture(scope="module")
def kit_clip():
    cfg = TP.ProcessConfig.kit()
    joints = synthesize(cfg, 30, seed=5, bone=0.6, drift=(4.0, 6.0))
    return joints, TP.build_target_offsets(joints, cfg)


@pytest.mark.parametrize("dataset", ["t2m", "kit"])
def test_process_file_matches_jax(dataset, golden, kit_clip):
    if dataset == "t2m":
        joints, tgt = golden["joints"], golden["tgt_offsets"]
        tcfg, jcfg = TP.ProcessConfig.t2m(), JP.ProcessConfig.t2m()
    else:
        joints, tgt = kit_clip
        tcfg, jcfg = TP.ProcessConfig.kit(), JP.ProcessConfig.kit()
    ref = JP.process_file(joints.copy(), jcfg, tgt)
    out = TP.process_file(joints.copy(), tcfg, tgt, device="cpu")
    assert _margin(np.asarray(ref[1]), jcfg) > 1e-3
    contacts = ref[0][:, -4:]
    assert 0 < contacts.mean() < 1  # both kinds of frames
    _assert_features(out[0], np.asarray(ref[0]))
    for o, r in zip(out[1:], ref[1:]):
        assert isinstance(o, np.ndarray) and o.shape == np.shape(r)
        np.testing.assert_allclose(o, np.asarray(r), atol=ATOL, rtol=0)
    assert out[0].shape[-1] == (263 if dataset == "t2m" else 251)


def test_process_pieces_match_jax(golden):
    cfg_t, cfg_j = TP.ProcessConfig.t2m(), JP.ProcessConfig.t2m()
    joints, tgt = golden["joints"], golden["tgt_offsets"]
    np.testing.assert_allclose(TP.build_target_offsets(joints, cfg_t),
                               JP.build_target_offsets(joints, cfg_j),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(TP.uniform_skeleton(joints, tgt, cfg_t),
                               JP.uniform_skeleton(joints, tgt, cfg_j),
                               atol=ATOL, rtol=0)
    _assert_features(TP.extract_features(joints, cfg_t),
                     JP.extract_features(joints, cfg_j))
    np.testing.assert_allclose(
        TP.process_file(joints.copy(), cfg_t, tgt)[0], golden["features"],
        atol=2e-3)


def _raw_dir(root, dataset, golden):
    """Three clips and a degenerate one-frame clip, named as the dataset's
    raw files are (KIT's ids go through ``_kit_rename``)."""
    d = root / f"raw_{dataset}"
    d.mkdir()
    if dataset == "t2m":
        cfg = TP.ProcessConfig.t2m()
        clips = {"000021": golden["joints"],
                 "000042": synthesize(cfg, 26, seed=1),
                 "000077": synthesize(cfg, 21, seed=2)}
    else:
        cfg = TP.ProcessConfig.kit()
        kw = dict(bone=0.6, drift=(4.0, 6.0))
        clips = {"03950_gt": synthesize(cfg, 30, seed=5, **kw),
                 "00017_mmm_01": synthesize(cfg, 24, seed=6, **kw),
                 "00018_mmm_00": synthesize(cfg, 22, seed=7, **kw)}
    for name, joints in clips.items():
        np.save(d / f"{name}.npy", joints)
    np.save(d / "00099_mmm_00.npy" if dataset == "kit" else d / "000099.npy",
            next(iter(clips.values()))[:1])
    return str(d)


def _listing(out):
    return sorted(os.path.relpath(os.path.join(r, f), out)
                  for r, _, fs in os.walk(out) for f in fs)


@pytest.mark.parametrize("dataset", ["t2m", "kit"])
def test_prepare_dataset_matches_jax(dataset, golden, tmp_path, capsys):
    raw = _raw_dir(tmp_path, dataset, golden)
    ref_dir, out_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    ref = JPD.prepare_dataset(raw, ref_dir, dataset)
    out = TPD.main(["--dataset", dataset, "--joints_dir", raw, "--out_dir",
                    out_dir, "--device", "cpu"])
    assert out == ref and out["kept"] == 3 and out["skipped"] == 1
    assert "3 clips kept, 1 skipped" in capsys.readouterr().out
    assert _listing(out_dir) == _listing(ref_dir)
    for f in sorted(os.listdir(os.path.join(ref_dir, "new_joint_vecs"))):
        _assert_features(
            np.load(os.path.join(out_dir, "new_joint_vecs", f)),
            np.load(os.path.join(ref_dir, "new_joint_vecs", f)))
        np.testing.assert_allclose(
            np.load(os.path.join(out_dir, "new_joints", f)),
            np.load(os.path.join(ref_dir, "new_joints", f)), atol=ATOL,
            rtol=0)
    for f in ("Mean.npy", "Std.npy", "meta/mean.npy", "meta/std.npy"):
        a, b = (np.load(os.path.join(d, f)) for d in (out_dir, ref_dir))
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_prepare_data_refuses_a_missing_card_and_a_missing_example(
        tmp_path, golden):
    raw = _raw_dir(tmp_path, "t2m", golden)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TPD.main(["--joints_dir", raw, "--out_dir",
                      str(tmp_path / "o")])
    with pytest.raises(FileNotFoundError, match="example clip"):
        TPD.prepare_dataset(raw, str(tmp_path / "o"), "t2m",
                            example_id="nope", device="cpu")
    assert TPD._kit_rename("03950_mmm_00.npy") == JPD._kit_rename(
        "03950_mmm_00.npy") == "03950mmm.npy"
