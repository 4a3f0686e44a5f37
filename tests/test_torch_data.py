"""The port's data plane against the JAX package's: annotation parsing,
``Text2MotionDataset`` on a HumanML3D-layout corpus written to ``tmp_path``,
the native (C++) store, ``DataLoader`` epochs on both paths, and
``tools/train.py --dataset t2m`` on the CPU.

Everything here is host-side numpy with the same seeds in both packages
(``random.Random`` for sub-clip names, captions and Python crops; the C++
store's xorshift for native crops; numpy for the normalizer's float32
sums), so the port is held to the JAX package's values EXACTLY: names,
lengths, normalizer bytes, items and batches.
"""

import os

import numpy as np
import pytest

from motiondiffusion_moe_tpu import config as jax_config
from motiondiffusion_moe_tpu.data import dataset as JD
from motiondiffusion_moe_tpu.data import loader as JL
from motiondiffusion_moe_tpu.data import native as JN
from motiondiffusion_moe_tpu_torch import config as port_config
from motiondiffusion_moe_tpu_torch.data import dataset as TD
from motiondiffusion_moe_tpu_torch.data import loader as TL
from motiondiffusion_moe_tpu_torch.data import native as TN

MAX_LEN = 96


def write_corpus(root, seed=0, dim=263):
    """A HumanML3D-layout corpus: whole clips, sub-clip lines (at 20 fps,
    several per id, so their random names can clash and redraw), an id
    with only sub-clips, motions out of the 40 <= len < 200 range, an id
    without a motion file and one without a text file, blank and NaN-tag
    lines."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "new_joint_vecs"), exist_ok=True)
    os.makedirs(os.path.join(root, "texts"), exist_ok=True)
    lengths = [60, 150, 45, 199, 200, 30, 120, 80, 90, 180, 110, 70]
    names = []
    for k, T in enumerate(lengths):
        name = f"{k:06d}"
        names.append(name)
        motion = (rng.standard_normal((T, dim)) * rng.uniform(0.5, 2.0)
                  + rng.standard_normal(dim)).astype(np.float32)
        if k != 7:  # 000007 has no motion
            np.save(os.path.join(root, "new_joint_vecs", name + ".npy"),
                    motion)
        if k == 8:  # 000008 has no text
            continue
        lines = []
        if k != 6:  # 000006 has sub-clips only
            lines.append(f"a person does action {k}#a/DET person/NOUN"
                         f"#0.0#0.0")
            lines.append(f"someone moves {k} times#someone/PRON#nan#nan")
        if T >= 100:
            lines += [f"part one of {k}#x/X#0.0#2.5",
                      f"part two of {k}#x/X#1.0#4.0",
                      f"too short {k}#x/X#1.0#2.0",   # 20 frames
                      f"part three of {k}#x/X#0.5#3.5",
                      "", f"part four of {k}#x/X#2.0#5.0"]
        with open(os.path.join(root, "texts", name + ".txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    names.append("999999")  # in the split, in no directory
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(names) + "\n")


def configs(root, **kw):
    fields = dict(data_root=str(root), max_motion_length=MAX_LEN, **kw)
    return (jax_config.DataConfig(**fields),
            port_config.DataConfig(**fields))


@pytest.fixture()
def corpus(tmp_path):
    write_corpus(tmp_path)
    return tmp_path


@pytest.mark.parametrize("line", [
    "a man walks#a/DET man/NOUN walk/VERB#0.0#0.0",
    "a man walks#a/DET man/NOUN#nan#nan",
    "a man walks#a/DET man/NOUN#1.5#nan",
    "a man walks#a/DET man/NOUN#2.0#4.5\n",
    "a man walks#a/DET man/NOUN",
    "a man walks",
    "  only a caption  \n"])
def test_parse_text_annotation_matches_jax(line):
    assert TD.parse_text_annotation(line).__dict__ == \
        JD.parse_text_annotation(line).__dict__


def test_dataset_matches_jax_item_for_item(corpus):
    jcfg, tcfg = configs(corpus)
    ref = JD.Text2MotionDataset(jcfg, seed=3, times=2, use_native=False)
    out = TD.Text2MotionDataset(tcfg, seed=3, times=2, use_native=False)
    assert out.name_list == ref.name_list
    assert any(n[1] == "_" for n in out.name_list)  # sub-clips were kept
    assert "000006" not in out.name_list and "000007" not in out.name_list
    np.testing.assert_array_equal(out.length_arr, ref.length_arr)
    assert out.normalizer.mean.tobytes() == ref.normalizer.mean.tobytes()
    assert out.normalizer.std.tobytes() == ref.normalizer.std.tobytes()
    assert len(out) == len(ref) == 2 * out.real_len()
    for name in out.name_list:
        a, b = out.data_dict[name], ref.data_dict[name]
        assert a["length"] == b["length"]
        assert [t.__dict__ for t in a["text"]] == \
            [t.__dict__ for t in b["text"]]
    for i in range(len(out)):  # crops and captions from the same rng
        (c1, m1, l1), (c2, m2, l2) = out[i], ref[i]
        assert (c1, l1) == (c2, l2)
        np.testing.assert_array_equal(m1, m2)


def test_dataset_with_a_given_normalizer_and_kit_lengths(corpus):
    jcfg, tcfg = configs(corpus, min_motion_length=24)
    norm = np.full(263, 0.5, np.float32), np.full(263, 2.0, np.float32)
    ref = JD.Text2MotionDataset(jcfg, seed=1, use_native=False,
                                normalizer=JD.MotionNormalizer(*norm))
    out = TD.Text2MotionDataset(
        tcfg, seed=1, use_native=False,
        normalizer=TD.MotionNormalizer(*norm))
    assert out.name_list == ref.name_list
    assert "000005" in out.name_list  # 30 frames: kept at KIT's 24
    for i in range(len(out)):
        np.testing.assert_array_equal(out[i][1], ref[i][1])


def test_no_usable_motion_raises(tmp_path):
    os.makedirs(tmp_path / "new_joint_vecs")
    (tmp_path / "train.txt").write_text("000001\n")
    with pytest.raises(FileNotFoundError, match="no usable motions"):
        TD.Text2MotionDataset(configs(tmp_path)[1])


def test_native_store_batches_equal_jax(corpus):
    assert JN.native_available() and TN.native_available()
    jcfg, tcfg = configs(corpus)
    ref = JD.Text2MotionDataset(jcfg, seed=2)
    out = TD.Text2MotionDataset(tcfg, seed=2)
    assert ref.has_native and out.has_native
    idx = list(range(out.real_len())) * 3
    for seed in (0, 7, 123456):
        (c1, m1, l1), (c2, m2, l2) = (out.get_batch(idx, seed=seed),
                                      ref.get_batch(idx, seed=seed))
        assert c1 == c2
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_array_equal(m1, m2)
    # uncropped items equal the Python path, padding normalised as zeros
    short = [i for i in range(out.real_len())
             if out.length_arr[i] < MAX_LEN]
    py = TD.Text2MotionDataset(tcfg, seed=2, use_native=False)
    _, mn, ln = out.get_batch(short, seed=5)
    _, mp, lp = py.get_batch(short, seed=5)
    np.testing.assert_array_equal(ln, lp)
    np.testing.assert_allclose(mn, mp, atol=1e-6, rtol=0)


def test_native_stores_agree_on_files_and_crops(tmp_path):
    rng = np.random.default_rng(4)
    a = rng.standard_normal((130, 6)).astype(np.float32)
    path = str(tmp_path / "a.npy")
    np.save(path, a)
    mean, std = a.mean(0), a.std(0) + 0.1
    stores = (TN.NativeMotionStore(), JN.NativeMotionStore())
    for s in stores:
        assert s.add_file(path) == 0 and s.add_array(a[:50]) == 1
        assert len(s) == 2 and s.item_length(0) == 130
    outs = [s.assemble_batch([0, 1, 0, 0], 64, mean, std, seed=9,
                             num_threads=n)
            for s, n in zip(stores, (3, 1))]
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    with pytest.raises(IOError):
        stores[0].add_file(str(tmp_path / "missing.npy"))
    with pytest.raises(ValueError, match="bad index"):
        stores[0].assemble_batch([5], 8, mean, std)


def test_native_store_rejects_a_mixed_dim_batch():
    store = TN.NativeMotionStore()
    store.add_array(np.zeros((5, 8), np.float32))
    j = store.add_array(np.zeros((5, 6), np.float32))
    ok, _ = store.assemble_batch([0], 8, np.zeros(8), np.ones(8))
    assert ok.shape == (1, 8, 8)
    with pytest.raises(ValueError, match="feature dim"):  # rc -2
        store.assemble_batch([0, j], 8, np.zeros(8), np.ones(8))


def test_native_io_raises_when_the_library_cannot_be_built(corpus,
                                                           tmp_path,
                                                           monkeypatch):
    """No silent fall back to the Python path (the JAX package swallows
    the failure): the compiler's failure reaches the caller."""
    monkeypatch.setattr(TN, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(TN, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(TN, "_lib", None)
    tcfg = configs(corpus)[1]
    assert not TN.native_available()
    assert "no-such-g++" in TN.build_error()
    with pytest.raises(RuntimeError, match="native motionio unavailable"):
        TD.Text2MotionDataset(tcfg)
    assert not TD.Text2MotionDataset(tcfg, use_native=False).has_native
    assert not os.listdir(tmp_path / "build")  # no half-written library


def test_library_is_built_where_the_port_keeps_its_builds():
    path = TN.build()
    assert os.path.dirname(path) == TN.BUILD_DIR
    assert os.path.basename(path).startswith("libmotionio_")
    assert TN.library_path() == path


@pytest.mark.parametrize("native", [True, False])
def test_loader_epochs_equal_jax(corpus, native):
    jcfg, tcfg = configs(corpus)
    ref = JD.Text2MotionDataset(jcfg, seed=5, use_native=native)
    out = TD.Text2MotionDataset(tcfg, seed=5, use_native=native)
    assert out.has_native == native
    for epoch in (0, 1):
        batches = []
        for ds, L in ((out, TL), (ref, JL)):
            loader = L.DataLoader(ds, batch_size=3, seed=11, prefetch=False)
            loader.set_epoch(epoch)
            batches.append(list(loader))
        assert len(batches[0]) == len(batches[1]) == len(out) // 3
        for (c1, m1, l1), (c2, m2, l2) in zip(*batches):
            assert c1 == c2
            np.testing.assert_array_equal(l1, l2)
            np.testing.assert_array_equal(m1, m2)
            assert m1.dtype == np.float32 and l1.dtype == np.int32


def test_loader_prefetch_gives_the_same_batches(corpus):
    tcfg = configs(corpus)[1]
    runs = []
    for prefetch in (False, True):
        ds = TD.Text2MotionDataset(tcfg, seed=5)
        runs.append(list(TL.DataLoader(ds, batch_size=2, seed=1,
                                       prefetch=prefetch)))
    for (c1, m1, _), (c2, m2, _) in zip(*runs):
        assert c1 == c2
        np.testing.assert_array_equal(m1, m2)


def test_train_cli_trains_on_a_t2m_corpus_on_the_cpu(corpus, tmp_path):
    """tools/train.py --dataset t2m --device cpu: one batch of 2 (the
    cond and uncond steps) at a tiny width, the normalizer in meta/."""
    import torch

    from motiondiffusion_moe_tpu_torch.data.normalizer import (
        MotionNormalizer)
    from motiondiffusion_moe_tpu_torch.tools import train as train_cli

    (corpus / "train.txt").write_text("000000\n000002\n000007\n")
    ds = TD.Text2MotionDataset(configs(corpus)[1], seed=0)
    assert ds.name_list == ["000002", "000000"]
    state = train_cli.main([
        "--dataset", "t2m", "--data_root", str(corpus), "--device", "cpu",
        "--num_layers", "1", "--latent_dim", "64", "--ff_size", "32",
        "--text_latent_dim", "16", "--batch_size", "2",
        "--num_epochs", "1", "--log_every", "1", "--checkpoint_dir",
        str(tmp_path / "ck")])
    assert state.step == 2
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    meta = MotionNormalizer.load(str(tmp_path / "ck" / "t2m_moe_small"
                                     / "meta"))
    assert meta.mean.tobytes() == ds.normalizer.mean.tobytes()
    assert meta.std.tobytes() == ds.normalizer.std.tobytes()
