"""orbax's PyTree checkpoint layout over zarr v2, read and written without
orbax, tensorstore or JAX.

A step that the JAX package's ``CheckpointManager`` saves
(``ocp.args.StandardSave``) is a directory ``<N>/`` holding
``_CHECKPOINT_METADATA`` (JSON) and the item ``default/``:

- ``default/_METADATA`` (JSON): ``tree_metadata`` keys each leaf by the
  string of its key tuple (``"('opt_state', '1', '0', 'mu', ...)"``) with
  each key's type (1 a sequence index, 2 a dict key) and the value's type
  (``"None"`` for an empty node, which holds no array); ``use_ocdbt`` says
  where the arrays are.
- The arrays are zarr v2 arrays named by the dotted key
  (``params.params.joint_embed.kernel``): ``<name>/.zarray`` (shape,
  chunks, dtype, compressor, fill value, order) and one file per chunk,
  keyed by its grid index (``0.0``; ``0`` for a scalar). With
  ``use_ocdbt`` they are keys of one OCDBT database in ``default/``
  (``utils/ocdbt.py``), else files in ``default/<name>/``.

:func:`read_step` reads either layout into nested dicts and lists of
tensors (bf16 as ``torch.bfloat16``, from its raw words). :func:`write_step`
writes the plain layout (``use_ocdbt: false``, uncompressed chunks), which
orbax restores as it restores its own: into a temporary
``<N>.orbax-checkpoint-tmp-<ns>`` directory renamed to ``<N>`` at the end,
so that a crash leaves no step that either package lists. orbax writes no
other file for a single-process step (no ``_sharding``, no
``array_metadatas/``), and needs none to list and restore one.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from motiondiffusion_moe_tpu_torch.utils import zstd

TMP_SUFFIX = ".orbax-checkpoint-tmp-"
_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")
# zarr v2 dtype string -> numpy dtype of the decoded words (bf16 as uint16)
_NP = {"<f4": np.float32, "<f8": np.float64, "<i4": np.int32,
       "<i8": np.int64, "<u4": np.uint32, "|b1": np.bool_,
       "bfloat16": np.uint16}
_ZARR = {torch.float32: "<f4", torch.float64: "<f8", torch.int32: "<i4",
         torch.int64: "<i8", torch.uint32: "<u4", torch.bool: "|b1",
         torch.bfloat16: "bfloat16"}
KEY_INDEX, KEY_DICT = 1, 2
# arrays read or written at once (file reads and writes, zstd and the
# copies release the GIL)
IO_THREADS = 8


def is_step_dir(name: str) -> bool:
    """An orbax step directory's name (no prefix): its number alone. The
    temporary names of unfinished saves do not count."""
    return name.isdigit()


# ---------------------------------------------------------------------------
# read
# ---------------------------------------------------------------------------

class _PlainStore:
    """The arrays of a ``use_ocdbt: false`` step: one directory each."""

    def __init__(self, root: str):
        self.root = root

    def view(self, key: str):
        path = os.path.join(self.root, *key.split("/"))
        try:
            with open(path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise KeyError(key) from None

    def readinto(self, key: str, out: np.ndarray) -> bool:
        """Read the file of ``key`` straight into ``out``; False when it
        is absent."""
        path = os.path.join(self.root, *key.split("/"))
        try:
            f = open(path, "rb")
        except FileNotFoundError:
            return False
        with f:
            size = os.fstat(f.fileno()).st_size
            if size != out.nbytes:
                raise ValueError(f"{path}: {size} bytes, expected "
                                 f"{out.nbytes}")
            f.readinto(memoryview(out.reshape(-1).view(np.uint8)))
        return True


def _store(item: str, use_ocdbt: bool):
    if use_ocdbt:
        from motiondiffusion_moe_tpu_torch.utils.ocdbt import OcdbtReader
        return OcdbtReader(item)
    return _PlainStore(item)


def _fill(zarray: dict, dtype):
    fill = zarray.get("fill_value")
    if fill is None:
        return None
    if zarray["dtype"] == "bfloat16":
        # a float fill value, as its bf16 word (round to nearest even)
        word = np.float32(fill).view(np.uint32)
        word = (word + 0x7FFF + ((word >> 16) & 1)) >> 16
        return np.uint16(word)
    if isinstance(fill, str):  # "NaN", "Infinity", "-Infinity"
        fill = float(fill.replace("Infinity", "inf"))
    return np.asarray(fill).astype(dtype)


def read_array(store, name: str) -> torch.Tensor:
    """The zarr v2 array ``name`` of ``store`` as a CPU tensor."""
    meta = json.loads(bytes(store.view(f"{name}/.zarray")))
    where = f"{name}/.zarray"
    if meta.get("zarr_format", 2) != 2:
        raise ValueError(f"{where}: zarr_format {meta.get('zarr_format')}")
    if meta["dtype"] not in _NP:
        raise ValueError(f"{where}: dtype {meta['dtype']!r} is not read "
                         f"(known: {sorted(_NP)})")
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError(f"{where}: only C order without filters is read")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{where}: compressor {comp.get('id')!r} is not "
                         "read (zstd or null)")
    sep = meta.get("dimension_separator", ".")
    dtype = np.dtype(_NP[meta["dtype"]])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    out = np.empty(shape, dtype)
    fill = _fill(meta, dtype)
    grid = [math.ceil(s / c) if c else 0 for s, c in zip(shape, chunks)]
    whole = chunks == shape
    for idx in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        dst = out if whole else np.empty(chunks, dtype)
        if not _read_chunk(store, key, comp, dst):
            if fill is None:
                raise ValueError(f"{name}: chunk {key} is missing and the "
                                 "array has no fill value")
            dst[...] = fill
        if not whole:
            region = tuple(slice(i * c, min((i + 1) * c, s))
                           for i, c, s in zip(idx, chunks, shape))
            out[region] = dst[tuple(slice(0, r.stop - r.start)
                                    for r in region)]
    t = torch.from_numpy(out)
    return t.view(torch.bfloat16) if meta["dtype"] == "bfloat16" else t


def _read_chunk(store, key: str, comp, dst: np.ndarray) -> bool:
    """Decode chunk ``key`` into ``dst``; False when the store lacks it."""
    flat = memoryview(dst.reshape(-1).view(np.uint8))
    if comp is None and isinstance(store, _PlainStore):
        return store.readinto(key, dst)
    try:
        raw = store.view(key)
    except KeyError:
        return False
    if comp is None:
        if len(raw) != dst.nbytes:
            raise ValueError(f"{key}: {len(raw)} bytes, expected "
                             f"{dst.nbytes}")
        flat[:] = memoryview(raw).cast("B")
    else:
        zstd.decompress_into(raw, flat, what=key)
    return True


def _key_parts(entry: dict) -> List[Tuple[str, int]]:
    return [(k["key"], int(k["key_type"])) for k in entry["key_metadata"]]


class _Seq(dict):
    """A sequence node while the tree is built (index -> child)."""


def _as_tree(node):
    """Built nodes -> dicts and lists: a :class:`_Seq` becomes a list, None
    where an index has no value."""
    if isinstance(node, _Seq):
        out = [None] * (max(node) + 1 if node else 0)
        for i, v in node.items():
            out[i] = _as_tree(v)
        return out
    if isinstance(node, dict):
        return {k: _as_tree(v) for k, v in node.items()}
    return node


def read_step(step_dir: str,
              top: Optional[Tuple[str, ...]] = None) -> Dict[str, Any]:
    """The tree saved at ``step_dir`` (``<ckpt>/<N>``): nested dicts (dict
    keys) and lists (sequence indices) of CPU tensors. Empty nodes
    (``value_type "None"``) are left out of dicts and are None in lists.
    ``top`` names the top-level keys to read (default: all)."""
    item = os.path.join(step_dir, "default")
    with open(os.path.join(item, "_METADATA")) as f:
        meta = json.load(f)
    store = _store(item, bool(meta.get("use_ocdbt", True)))
    try:
        root: dict = {}
        arrays = []
        for entry in meta["tree_metadata"].values():
            parts = _key_parts(entry)
            if top is not None and parts[0][0] not in top:
                continue
            if entry["value_metadata"]["value_type"] == "None":
                _place(root, parts, None, skip=True)
            else:
                arrays.append(parts)
        with ThreadPoolExecutor(IO_THREADS) as pool:
            values = pool.map(lambda parts: read_array(
                store, ".".join(k for k, _ in parts)), arrays)
            for parts, value in zip(arrays, values):
                _place(root, parts, value)
        return _as_tree(root)
    finally:
        if hasattr(store, "close"):
            store.close()


def _place(root: dict, parts, value, skip: bool = False) -> None:
    """Put ``value`` at ``parts``; an empty node (``skip``) is left out of
    a dict but keeps its index in a sequence (as None), so that the
    sequence keeps its length."""
    node = root
    for i, (key, kind) in enumerate(parts):
        k = int(key) if kind == KEY_INDEX else key
        last = i == len(parts) - 1
        if last:
            if not skip or isinstance(node, _Seq):
                node[k] = None if skip else value
            return
        nxt_kind = parts[i + 1][1]
        if k not in node:
            node[k] = _Seq() if nxt_kind == KEY_INDEX else {}
        node = node[k]


# ---------------------------------------------------------------------------
# write
# ---------------------------------------------------------------------------

def flatten(tree, prefix: Tuple[Tuple[str, int], ...] = ()
            ) -> Iterator[Tuple[Tuple[Tuple[str, int], ...], Any]]:
    """(key path, leaf) in JAX's flattening order: dict keys sorted,
    sequences in order; None is a leaf here (orbax records it as an empty
    node)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten(tree[k], prefix + ((str(k), KEY_DICT),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten(v, prefix + ((str(i), KEY_INDEX),))
    else:
        yield prefix, tree


def _leaf_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous()
    return torch.from_numpy(np.asarray(x, order="C"))


def _write_array(root: str, name: str, t: torch.Tensor) -> int:
    if t.dtype not in _ZARR:
        raise ValueError(f"{name}: dtype {t.dtype} has no zarr v2 name here")
    shape = list(t.shape)
    if any(s == 0 for s in shape):
        raise ValueError(f"{name}: empty arrays are not written")
    d = os.path.join(root, name)
    os.mkdir(d)
    meta = {"chunks": shape, "compressor": None, "dimension_separator": ".",
            "dtype": _ZARR[t.dtype], "fill_value": None, "filters": None,
            "order": "C", "shape": shape, "zarr_format": 2}
    with open(os.path.join(d, ".zarray"), "w") as f:
        f.write(json.dumps(meta, sort_keys=True, separators=(",", ":")))
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    words = t.numpy()
    with open(os.path.join(d, ".".join("0" * len(shape)) or "0"), "wb") as f:
        f.write(memoryview(words.reshape(-1).view(np.uint8)))
    return words.nbytes


def write_step(step_dir: str, tree, files: Optional[Dict[str, bytes]] = None
               ) -> int:
    """Write ``tree`` (nested dicts / lists / tuples of tensors or numpy
    arrays, None for an empty node) as the orbax step ``step_dir``, plain
    layout, plus ``files`` (name -> bytes) beside ``_CHECKPOINT_METADATA``.
    Returns the bytes of array data written. Raises when ``step_dir``
    exists."""
    if os.path.exists(step_dir):
        raise FileExistsError(step_dir)
    start = time.time_ns()
    tmp = f"{step_dir.rstrip(os.sep)}{TMP_SUFFIX}{start}"  # orbax's name
    item = os.path.join(tmp, "default")
    os.makedirs(item)
    try:
        tree_meta, arrays = {}, []
        for parts, leaf in flatten(tree):
            keys = tuple(k for k, _ in parts)
            entry = {"key_metadata": [{"key": k, "key_type": kind}
                                      for k, kind in parts]}
            if leaf is None:
                entry["value_metadata"] = {"value_type": "None",
                                           "skip_deserialize": True}
            else:
                arrays.append((".".join(keys), leaf))
                entry["value_metadata"] = {"value_type": "np.ndarray",
                                           "skip_deserialize": False}
            tree_meta[str(keys)] = entry
        with ThreadPoolExecutor(IO_THREADS) as pool:
            nbytes = sum(pool.map(lambda a: _write_array(
                item, a[0], _leaf_tensor(a[1])), arrays))
        with open(os.path.join(item, "_METADATA"), "w") as f:
            json.dump({"tree_metadata": tree_meta, "use_ocdbt": False,
                       "use_zarr3": False,
                       "store_array_data_equal_to_fill_value": True,
                       "custom_metadata": None}, f)
        for name, data in (files or {}).items():
            with open(os.path.join(tmp, name), "wb") as f:
                f.write(data)
        with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
            json.dump({"item_handlers": {"default": _HANDLER},
                       "metrics": {}, "performance_metrics": {},
                       "init_timestamp_nsecs": start,
                       "commit_timestamp_nsecs": time.time_ns(),
                       "custom_metadata": {}}, f)
        os.rename(tmp, step_dir)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return nbytes
