"""Weight converter: the JAX package's flax param tree -> a state_dict.

`from_flax` takes the tree as nested dicts of numpy arrays (so nothing
here touches a JAX array) and returns the ``state_dict`` of the matching
``models/qnets.py`` or ``models/lstm_q.py`` module:
- a Conv kernel goes from HWIO to OIHW;
- a Dense kernel ``[in, out]`` becomes a Linear weight ``[out, in]``;
- biases carry over as they are;
- the columns of ``torso_out`` are permuted from flax's HWC flatten
  order to the CHW order of the port's NCHW torso (the one place the
  flatten permutation is taken; see models/qnets.py);
- the LSTM's per-gate kernels (``ii if ig io`` [F, H] without bias,
  ``hi hf hg ho`` [H, H] with bias) are concatenated in gate order
  i, f, g, o into ``weight_ih`` [4H, F], ``weight_hh`` [4H, H] and
  ``bias_hh`` [4H].
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def conv_weight(kernel: np.ndarray) -> torch.Tensor:
    """Flax Conv kernel [kh, kw, in, out] -> torch [out, in, kh, kw]."""
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def dense_weight(kernel: np.ndarray) -> torch.Tensor:
    """Flax Dense kernel [in, out] -> torch Linear weight [out, in]."""
    return _t(np.asarray(kernel).T)


def torso_out_weight(kernel: np.ndarray, channels: int) -> torch.Tensor:
    """`torso_out` kernel whose rows run over the conv output in HWC
    order -> a Linear weight whose columns run in CHW order."""
    k = np.asarray(kernel)
    hw = k.shape[0] // channels
    chw = k.reshape(hw, channels, -1).transpose(1, 0, 2)
    return _t(chw.reshape(channels * hw, -1).T)


def _linear(sd: dict, name: str, p: dict, weight=dense_weight) -> None:
    sd[f"{name}.weight"] = weight(p["kernel"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _head(sd: dict, p: dict, final_dense: str) -> None:
    if "DuelingHead_0" in p:
        _linear(sd, "head.value", p["DuelingHead_0"]["value"])
        _linear(sd, "head.advantage", p["DuelingHead_0"]["advantage"])
    else:
        _linear(sd, "out", p[final_dense])


def _nature_torso(sd: dict, torso: dict) -> None:
    n_conv = sum(1 for k in torso if k.startswith("Conv_"))
    for i in range(n_conv):
        _linear(sd, f"torso.convs.{i}", torso[f"Conv_{i}"],
                weight=conv_weight)
    channels = np.asarray(torso[f"Conv_{n_conv - 1}"]["bias"]).shape[0]
    _linear(sd, "torso.torso_out", torso["torso_out"],
            weight=lambda k: torso_out_weight(k, channels))


def _lstm_q(sd: dict, p: dict) -> None:
    """``ApeXLSTMQNet``: a Nature or one-dense torso, the cell, and a
    head named "head" (dueling or one dense)."""
    if "torso_out" in p["torso"]:
        _nature_torso(sd, p["torso"])
    else:
        _linear(sd, "torso", p["torso"])
    cell = p["lstm"]
    sd["lstm.weight_ih"] = dense_weight(np.concatenate(
        [np.asarray(cell[f"i{g}"]["kernel"]) for g in "ifgo"], axis=1))
    sd["lstm.weight_hh"] = dense_weight(np.concatenate(
        [np.asarray(cell[f"h{g}"]["kernel"]) for g in "ifgo"], axis=1))
    sd["lstm.bias_hh"] = _t(np.concatenate(
        [np.asarray(cell[f"h{g}"]["bias"]) for g in "ifgo"]))
    head = p["head"]
    if "value" in head:
        _linear(sd, "head.value", head["value"])
        _linear(sd, "head.advantage", head["advantage"])
    else:
        _linear(sd, "head", head)


def from_flax(params: Any) -> dict[str, torch.Tensor]:
    """Flax params of ``NatureDQN``, ``MLPQNet`` or ``ApeXLSTMQNet``
    (with or without the top-level "params" collection) -> state_dict
    for the same net."""
    p = params.get("params", params)
    sd: dict[str, torch.Tensor] = {}
    if "lstm" in p:
        _lstm_q(sd, p)
        return sd
    if "torso" in p:  # NatureDQN
        _nature_torso(sd, p["torso"])
        _head(sd, p, "Dense_0")
        return sd
    dense = sorted((k for k in p if k.startswith("Dense_")),
                   key=lambda k: int(k.split("_")[1]))
    hidden = dense if "DuelingHead_0" in p else dense[:-1]
    for i, name in enumerate(hidden):
        _linear(sd, f"hidden.{i}", p[name])
    _head(sd, p, dense[-1] if dense else "")
    return sd
