"""The port's motion codec (quaternions, skeleton, recover) against the JAX
package on the same seeded numpy inputs, and against the committed
reference goldens.

Tolerances: f32 math in both, in the same order of operations, where XLA
and PyTorch differ in the last bits of sqrt / trig / fused products ->
atol 1e-5 on unit-scale values (rotation angles in radians). The goldens
(the reference's own torch run) at the tolerances ``tests/test_motion.py``
holds the JAX package to.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import motiondiffusion_moe_tpu.motion as JM
import motiondiffusion_moe_tpu_torch.motion as TM

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures",
                        "motion_goldens.npz")
ATOL = 1e-5
ORDERS = ["xyz", "yzx", "zxy", "xzy", "yxz", "zyx"]


@pytest.fixture(scope="module")
def g():
    return np.load(FIXTURES)


def _unit_quats(rng, *shape):
    q = rng.standard_normal(shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _same(port, ref, atol=ATOL):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_allclose(port, np.asarray(ref), atol=atol, rtol=0)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return {
        "q": _unit_quats(rng, 6, 5),
        "r": _unit_quats(rng, 6, 5),
        "v": rng.standard_normal((6, 5, 3)).astype(np.float32),
        "v2": rng.standard_normal((6, 5, 3)).astype(np.float32),
        "raw": rng.standard_normal((6, 5, 4)).astype(np.float32) * 3,
        "cont6d": rng.standard_normal((6, 5, 6)).astype(np.float32),
        "expmap": rng.standard_normal((6, 5, 3)).astype(np.float32),
        # angles away from the poles, where asin's slope is unbounded
        "euler": rng.uniform(-60, 60, (6, 5, 3)).astype(np.float32),
        "t": np.linspace(0.0, 1.0, 7, dtype=np.float32),
    }


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("name", [
    "qinv", "qnormalize", "qmul", "qrot", "qbetween", "quaternion_to_matrix",
    "quaternion_to_cont6d", "cont6d_to_matrix", "expmap_to_quaternion",
    "qpow", "qslerp", "lerp"])
def test_quaternion_function_matches_jax(inputs, name):
    i = inputs
    args = {"qinv": (i["q"],), "qnormalize": (i["raw"],),
            "qmul": (i["q"], i["r"]), "qrot": (i["q"], i["v"]),
            "qbetween": (i["v"], i["v2"]),
            "quaternion_to_matrix": (i["raw"],),
            "quaternion_to_cont6d": (i["q"],),
            "cont6d_to_matrix": (i["cont6d"],),
            "expmap_to_quaternion": (i["expmap"],),
            # q [N, 4]: the fractions become the leading dim
            "qpow": (i["q"][0], i["t"]),
            "qslerp": (i["q"][0], i["r"][0], i["t"]),
            "lerp": (i["v"], i["v2"], i["t"])}[name]
    ref = getattr(JM, name)(*[jnp.asarray(a) for a in args])
    out = getattr(TM, name)(*[_t(a) for a in args])
    assert tuple(out.shape) == ref.shape
    _same(out, ref)


def test_scalar_fractions_match_jax(inputs):
    q, r, v, v2 = (inputs[k] for k in ("q", "r", "v", "v2"))
    q, r = q[0], r[0]
    _same(TM.qpow(_t(q), 0.3), JM.qpow(jnp.asarray(q), 0.3))
    _same(TM.qslerp(_t(q), _t(r), 0.7),
          JM.qslerp(jnp.asarray(q), jnp.asarray(r), 0.7))
    _same(TM.lerp(_t(v), _t(v2), 0.25),
          JM.lerp(jnp.asarray(v), jnp.asarray(v2), 0.25))


@pytest.mark.parametrize("order", ORDERS)
def test_euler_both_ways_match_jax_in_every_order(inputs, order):
    e = inputs["euler"]
    q = TM.euler2quat(_t(e), order)
    _same(q, JM.euler2quat(jnp.asarray(e), order))
    _same(TM.euler2quat(_t(np.deg2rad(e)), order, deg=False),
          JM.euler2quat(jnp.asarray(np.deg2rad(e)), order, deg=False))
    _same(TM.qeuler(q, order, deg=False),
          JM.qeuler(jnp.asarray(q.numpy()), order, deg=False))
    # and the angles back, in degrees (1e-5 rad of asin / atan2 is ~6e-4)
    back = TM.qeuler(q, order)
    _same(back, JM.qeuler(jnp.asarray(q.numpy()), order), atol=1e-3)
    _same(back, e, atol=1e-3)


def test_qeuler_rejects_an_unknown_order(inputs):
    with pytest.raises(ValueError, match="unknown euler order"):
        TM.qeuler(_t(inputs["q"]), "xxy")


def test_qfix_matches_jax_on_numpy_and_tensors():
    rng = np.random.default_rng(1)
    q = _unit_quats(rng, 40, 6)
    q[rng.random((40, 6)) < 0.3] *= -1  # sign jumps along time
    ref = JM.qfix(q)
    out = TM.qfix(q)
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(TM.qfix(_t(q)).numpy(), ref)


# ---------------------------------------------------------------- skeleton


def _ref_joints():
    """A t2m rest pose: each child 0.3 along its raw offset direction."""
    joints = np.zeros((22, 3), np.float32)
    for chain in JM.T2M_KINEMATIC_CHAIN:
        for a, b in zip(chain[:-1], chain[1:]):
            joints[b] = joints[a] + 0.3 * JM.T2M_RAW_OFFSETS[b]
    return joints


@pytest.fixture()
def skeletons():
    """Fresh each time: FK with ``skel_joints`` keeps the batch's offsets
    (in both packages)."""
    ref = _ref_joints()
    js = JM.Skeleton(JM.T2M_RAW_OFFSETS, JM.T2M_KINEMATIC_CHAIN)
    js.get_offsets_joints(jnp.asarray(ref))
    ts = TM.Skeleton(TM.T2M_RAW_OFFSETS, TM.T2M_KINEMATIC_CHAIN)
    ts.get_offsets_joints(_t(ref))
    return js, ts


def test_skeleton_constants_are_the_jax_packages():
    for name in ("T2M_KINEMATIC_CHAIN", "KIT_KINEMATIC_CHAIN"):
        assert getattr(TM, name) == getattr(JM, name)
    for name in ("T2M_RAW_OFFSETS", "KIT_RAW_OFFSETS"):
        np.testing.assert_array_equal(getattr(TM, name), getattr(JM, name))
    for ds in ("t2m", "humanml3d", "kit", "kit-ml"):
        a, b = TM.get_skeleton_params(ds), JM.get_skeleton_params(ds)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]
    with pytest.raises(ValueError):
        TM.get_skeleton_params("nope")


def test_skeleton_fk_ik_match_jax(skeletons):
    js, ts = skeletons
    _same(ts.offset(), js.offset())
    assert ts.parents == js.parents and ts.njoints == 22
    rng = np.random.default_rng(2)
    quat = _unit_quats(rng, 4, 22)
    root = rng.standard_normal((4, 3)).astype(np.float32)
    joints = ts.forward_kinematics(_t(quat), _t(root))
    _same(joints, js.forward_kinematics(jnp.asarray(quat), jnp.asarray(root)))
    _same(ts.forward_kinematics(_t(quat), _t(root), do_root_R=False),
          js.forward_kinematics(jnp.asarray(quat), jnp.asarray(root),
                                do_root_R=False))
    c6 = rng.standard_normal((4, 22, 6)).astype(np.float32)
    _same(ts.forward_kinematics_cont6d(_t(c6), _t(root)),
          js.forward_kinematics_cont6d(jnp.asarray(c6), jnp.asarray(root)))
    # per-item skeletons from a batch of poses
    poses = (_ref_joints()[None] * rng.uniform(0.8, 1.2, (4, 1, 1))
             ).astype(np.float32)
    _same(ts.forward_kinematics(_t(quat), _t(root), skel_joints=_t(poses)),
          js.forward_kinematics(jnp.asarray(quat), jnp.asarray(root),
                                skel_joints=jnp.asarray(poses)))
    for smooth in (False, True):
        ik = ts.inverse_kinematics(joints.numpy(), [2, 1, 17, 16],
                                   smooth_forward=smooth)
        assert isinstance(ik, np.ndarray)
        _same(ik, js.inverse_kinematics(joints.numpy(), [2, 1, 17, 16],
                                        smooth_forward=smooth))


def test_recover_from_rot_matches_jax(skeletons):
    js, ts = skeletons
    rng = np.random.default_rng(3)
    feats = (0.1 * rng.standard_normal((2, 12, 263))).astype(np.float32)
    _same(TM.recover_from_rot(_t(feats), 22, ts),
          JM.recover_from_rot(jnp.asarray(feats), 22, js))


# ---------------------------------------------------------------- goldens


class TestGoldens:
    """The committed reference goldens, at tests/test_motion.py's
    tolerances."""

    @pytest.mark.parametrize("name,args,atol", [
        ("qmul", ("q", "r"), 1e-5), ("qrot", ("q", "v"), 1e-5),
        ("qinv", ("q",), 1e-7), ("qbetween", ("v", "v2"), 1e-4),
        ("q2mat", ("q",), 1e-5), ("q2cont6d", ("q",), 1e-5),
        ("cont6d2mat", ("cont6d",), 1e-5),
        ("euler2quat_xyz", ("euler",), 1e-5), ("qeuler_xyz", ("q",), 1e-3),
        ("expmap2quat", ("expmap",), 1e-5)])
    def test_quaternion_golden(self, g, name, args, atol):
        fn = {"q2mat": TM.quaternion_to_matrix,
              "q2cont6d": TM.quaternion_to_cont6d,
              "cont6d2mat": TM.cont6d_to_matrix,
              "euler2quat_xyz": lambda e: TM.euler2quat(e, "xyz"),
              "qeuler_xyz": lambda q: TM.qeuler(q, "xyz"),
              "expmap2quat": TM.expmap_to_quaternion}.get(
                  name, getattr(TM, name, None))
        _same(fn(*[_t(g[a]) for a in args]), g[name], atol=atol)

    def test_qfix_golden(self, g):
        np.testing.assert_array_equal(TM.qfix(g["qseq"]), g["qfix"])

    def test_skeleton_goldens(self, g):
        s = TM.Skeleton(TM.T2M_RAW_OFFSETS, TM.T2M_KINEMATIC_CHAIN)
        s.get_offsets_joints(_t(g["ref_joints"]))
        _same(s.offset(), g["skel_offsets"])
        _same(s.forward_kinematics(_t(g["fk_quat_params"]),
                                   _t(g["fk_root_pos"])),
              g["fk_joints"], atol=1e-4)
        _same(s.forward_kinematics_cont6d(_t(g["fk_cont6d_params"]),
                                          _t(g["fk_root_pos"])),
              g["fk_cont6d_joints"], atol=1e-4)
        _same(s.inverse_kinematics(g["fk_joints"], [2, 1, 17, 16]),
              g["ik_quat"], atol=1e-3)

    def test_recover_goldens(self, g):
        rq, rp = TM.recover_root_rot_pos(_t(g["feats_t2m"]))
        _same(rq, g["root_quat"])
        _same(rp, g["root_pos"])
        _same(TM.recover_from_ric(_t(g["feats_t2m"]), 22), g["ric_joints"])
        s = TM.Skeleton(TM.T2M_RAW_OFFSETS, TM.T2M_KINEMATIC_CHAIN)
        s.set_offset(g["skel_offsets"])
        _same(TM.recover_from_rot(_t(g["feats_t2m"][0]), 22, s),
              g["rot_joints"], atol=1e-4)
