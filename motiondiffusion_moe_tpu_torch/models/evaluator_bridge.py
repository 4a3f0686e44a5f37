"""Weight bridge for the evaluator networks: flax params -> the port's
``state_dict``s (``eval/evaluator_models.py``).

Input: the ``params`` collection of a JAX evaluator module (or of each of
the JAX ``EvaluatorModelWrapper``'s three encoders) as nested dicts of numpy
arrays; this module never imports JAX. The port's modules carry the
reference's torch names (those of a released ``finest.tar``), so the rules
invert ``convert_torch_evaluator_checkpoint`` of the JAX package:

- a Dense ``kernel [in, out]`` -> ``weight [out, in]``; LayerNorm ``scale``
  -> ``weight``;
- ``nn.Conv`` (``conv1``, ``conv2``) ``kernel [k, in, out]`` -> ``Conv1d``
  ``weight [out, in, k]``;
- ``nn.ConvTranspose`` (``deconv1``, ``deconv2``, ``padding="SAME"``,
  which pads as torch's ``padding=1`` at k = 4, s = 2) ``kernel
  [k, in, out]`` -> ``ConvTranspose1d`` ``weight [in, out, k]`` with the
  spatial axis flipped (flax does not transpose the kernel);
- a ``MaskedBiGRU``'s ``fwd_w_ih`` ... ``bwd_b_hh`` -> ``weight_ih_l0``
  ... ``bias_hh_l0_reverse``; a GRU cell's (``gru_<i>``) ``w_ih`` ...
  ``b_hh`` -> ``gru.<i>.weight_ih`` ... ``bias_hh``;
- module names: ``conv1`` / ``conv2`` -> ``main.0`` / ``main.3``,
  ``deconv1`` / ``deconv2`` -> ``main.0`` / ``main.2``, ``output_net_<i>``
  -> ``output_net.<i>``, ``output_<i>`` -> ``output.<i>``, ``emb_dense`` /
  ``emb_norm`` -> ``emb.0`` / ``emb.1``, ``out_0`` / ``out_norm`` /
  ``out_1`` -> ``output.0`` / ``output.1`` / ``output.3``; every other
  name (``pos_emb``, ``input_emb``, ``hidden``, ``z2init``, ``mu_net``,
  ``W_q``, ...) stays.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_MODULES = {"conv1": "main.0", "conv2": "main.3", "deconv1": "main.0",
            "deconv2": "main.2", "emb_dense": "emb.0", "emb_norm": "emb.1",
            "out_0": "output.0", "out_norm": "output.1", "out_1": "output.3"}
_GRU = {"w_ih": "weight_ih", "w_hh": "weight_hh", "b_ih": "bias_ih",
        "b_hh": "bias_hh"}


def _module_name(name: str) -> str:
    if name in _MODULES:
        return _MODULES[name]
    m = re.fullmatch(r"(output_net|output|gru)_(\d+)", name)
    return f"{m.group(1)}.{m.group(2)}" if m else name


def _leaf(module: str, name: str, x: np.ndarray):
    """(torch parameter name, array) of one flax leaf of ``module``."""
    if name[:4] in ("fwd_", "bwd_") and name[4:] in _GRU:
        suffix = "_l0" + ("_reverse" if name.startswith("bwd") else "")
        return _GRU[name[4:]] + suffix, x
    if name in _GRU:
        return _GRU[name], x
    if name == "kernel":
        if x.ndim == 2:
            return "weight", x.T
        if module.startswith("deconv"):
            return "weight", np.transpose(x, (1, 2, 0))[..., ::-1]
        return "weight", np.transpose(x, (2, 1, 0))
    if name == "scale":
        return "weight", x
    return name, x


def evaluator_jax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """One evaluator module's flax ``params`` tree -> its port module's
    ``state_dict`` (float32)."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, path: tuple) -> None:
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, path + (key,))
                continue
            module = path[-1] if path else ""
            name, arr = _leaf(module, key, np.asarray(value, np.float32))
            parts = [_module_name(p) for p in path] + [name]
            sd[".".join(parts)] = torch.from_numpy(np.array(arr))

    walk(params, ())
    return sd


def evaluator_wrapper_state_dicts(params: Mapping
                                  ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX ``EvaluatorModelWrapper.params`` ({"movement", "text",
    "motion"}, each a flax variables dict) -> the port wrapper's
    ``state_dicts``."""
    return {key: evaluator_jax_to_state_dict(params[key]["params"])
            for key in ("movement", "text", "motion")}
