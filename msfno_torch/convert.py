"""Weight carry from the JAX package: flax parameter tree -> this package's
state_dict.

Backbone names and layouts follow the original MSFNO state_dict, as
msfno_tpu.models.convert.export_sfno_state_dict emits them (this is an
independent copy of that mapping for the parameters this package has):

  Dense kernel (in, out)        ->  1x1 conv weight (out, in, 1, 1)
  pos_embed (H, W, C)           ->  (1, C, H, W)
  norm scale / bias             ->  norm weight / bias ((H, W, 1) -> (H, W)
                                    for the layer norm)
  filter w{l} / wout (in, out, 2) -> filter_layer.filter.w.{l} / .wout
                                    (also the tt factors w0 / w1 / w2)
  filter w (K, in, out, 2)      ->  filter_layer.filter.w (out, in, K, 2)
  filter w (L, M, in, out, 2)   ->  filter_layer.filter.w (out, in, L, M, 2)
  filter act_bias (hidden,)     ->  filter_layer.filter.activation.bias
                                    (hidden, 1, 1)

The GCN FiLM generator, which the export skips, maps to
`film_gen.film_gen.{conv1,conv_i}.{weight (in, out), bias}` and
`film_gen.film_gen.head_film.{weight (out, in), bias}`.  The ViT generator
maps to the reference names that msfno_tpu/models/convert.py:517-545
emits: `film_gen.film_gen.to_patch_embedding.{norm1,lin,norm2}`,
`encoder_position_code` ((N, dim) -> (1, N, dim)),
`transformer.layers.{i}.0.{norm, to_qkv, to_out.0}`,
`transformer.layers.{i}.1.net.{0,1,4}` and `transformer.norm`, Dense
kernels (in, out) as Linear weights (out, in).  The MAE film head maps to
the reference's `film_gen.film_head.net.{0,1,4}` (msfno_tpu/models/
convert.py:73-93, 488-494), and ContextCast to names that follow its flax
modules, under `film_gen.film_gen.` in a filmed net and at the top level
of a `MAEWrapper` tree (`from_flax_mae_params`): flax adopts the attention
and feed-forward modules that ContextCast hands to `LayerScaled` under
auto names, `MaskedAttention_{k}` / `FeedForward_{k}` counted over the
encoder and then the decoder; they become `enc_attn_{k}.inner.*` /
`enc_ff_{k}.inner.*` for the first MAE_ENCODER_DEPTH (4, the only depth
either JAX wrapper builds) and `dec_attn_{k-4}` / `dec_ff_{k-4}` after.

`from_flax_afno_params` is the inverse of the JAX package's
`convert_afno_state_dict` (msfno_tpu/models/convert.py:304-396): a flax
AFNONet or PrecipNet tree -> the reference FourCastNet names and layouts.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, path))
        else:
            flat[path] = np.asarray(v)
    return flat


def _kind(leaf: str) -> str:
    return "weight" if leaf in ("kernel", "scale") else "bias"


def _dense_to_conv1x1(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)[..., None, None]


def _backbone_key(parts: list[str], v: np.ndarray):
    """(name, array) of a backbone leaf, or None if it is not one."""
    if parts == ["pos_embed"]:
        return "pos_embed", np.ascontiguousarray(np.transpose(v, (2, 0, 1)))[None]
    if parts[0] in ("encoder", "decoder") and len(parts) == 3:
        idx = "0" if parts[1] == "fc1" else "2"
        name = f"{parts[0]}.fwd.{idx}.{_kind(parts[2])}"
        return name, _dense_to_conv1x1(v) if parts[2] == "kernel" else v
    m = re.match(r"^blocks_(\d+)$", parts[0])
    if not m:
        return None
    base, rest = f"blocks.{m.group(1)}", parts[1:]
    if rest[0] in ("norm0", "norm1") and len(rest) == 2:
        return f"{base}.{rest[0]}.{_kind(rest[1])}", v[..., 0] if v.ndim == 3 else v
    if rest[0] == "filter" and len(rest) == 2:
        if rest[1] == "wout":
            return f"{base}.filter_layer.filter.wout", v
        if rest[1] == "w":
            # linear filters: the reference's (out, in, modes..., 2)
            perm = (3, 2, 0, 1, 4) if v.ndim == 5 else (2, 1, 0, 3)
            return f"{base}.filter_layer.filter.w", np.ascontiguousarray(np.transpose(v, perm))
        if rest[1] == "act_bias":
            return f"{base}.filter_layer.filter.activation.bias", v.reshape(-1, 1, 1)
        if re.match(r"^w\d+$", rest[1]):
            return f"{base}.filter_layer.filter.w.{rest[1][1:]}", v
    if rest[0] == "inner_skip" and len(rest) == 2:
        return (f"{base}.inner_skip.{_kind(rest[1])}",
                _dense_to_conv1x1(v) if rest[1] == "kernel" else v)
    if rest[0] == "mlp" and len(rest) == 3:
        idx = "0" if rest[1] == "fc1" else "2"
        return (f"{base}.mlp.fwd.{idx}.{_kind(rest[2])}",
                _dense_to_conv1x1(v) if rest[2] == "kernel" else v)
    return None


_FF = {"norm": "0", "fc1": "1", "fc2": "4"}  # FeedForward's Sequential indices


def _linear(leaf: str, v: np.ndarray) -> np.ndarray:
    """A Dense leaf as a Linear's: the kernel (in, out) transposed."""
    return np.ascontiguousarray(v.T) if leaf == "kernel" else v


def _vit_key(g: list[str], v: np.ndarray):
    """(name under film_gen.film_gen, array) of a ViT generator leaf."""
    if g[0] in ("patch_norm1", "patch_norm2") and len(g) == 2:
        return f"to_patch_embedding.norm{g[0][-1]}.{_kind(g[1])}", v
    if g[0] == "patch_proj" and len(g) == 2:
        return f"to_patch_embedding.lin.{_kind(g[1])}", _linear(g[1], v)
    if g == ["encoder_position_code"]:
        return "encoder_position_code", v[None]
    if g[0] != "transformer":
        return None
    if g[1] == "norm" and len(g) == 3:
        return f"transformer.norm.{_kind(g[2])}", v
    m = re.match(r"^(attn|ff)_(\d+)$", g[1])
    if not m or len(g) != 4:
        return None
    sub, i = m.groups()
    if sub == "ff":
        return f"transformer.layers.{i}.1.net.{_FF[g[2]]}.{_kind(g[3])}", _linear(g[3], v)
    layer = {"norm": "norm", "to_qkv": "to_qkv", "to_out": "to_out.0"}[g[2]]
    return f"transformer.layers.{i}.0.{layer}.{_kind(g[3])}", _linear(g[3], v)


MAE_ENCODER_DEPTH = 4  # ContextCast's encoder depth in both JAX wrappers
_MAE_LEAVES = {"encoder_position_code", "decoder_position_code", "class_token", "mask_token"}


def _mae_key(g: list[str], v: np.ndarray):
    """(name within ContextCast, array) of a ContextCast leaf, or None."""
    if len(g) == 1 and g[0] in _MAE_LEAVES:
        return g[0], v
    if len(g) == 2 and g[0] in ("patch_norm1", "patch_norm2", "dec_proj_norm",
                                "to_mean_norm", "to_std_norm", "patch_proj", "dec_proj",
                                "to_mean", "to_std"):
        return f"{g[0]}.{_kind(g[1])}", _linear(g[1], v)
    m = re.match(r"^(MaskedAttention|FeedForward)_(\d+)$", g[0])
    if m and len(g) == 3:
        kind, k = m.group(1), int(m.group(2))
        side, i = ("enc", k) if k < MAE_ENCODER_DEPTH else ("dec", k - MAE_ENCODER_DEPTH)
        if kind == "FeedForward":
            return f"{side}_ff_{i}.inner.net.{_FF[g[1]]}.{_kind(g[2])}", _linear(g[2], v)
        layer = {"norm": "norm", "to_qkv": "to_qkv", "to_out": "to_out.0"}[g[1]]
        return f"{side}_attn_{i}.inner.{layer}.{_kind(g[2])}", _linear(g[2], v)
    if re.match(r"^(enc|dec)_(attn|ff)_\d+$", g[0]) and g[1:] == ["gamma"]:
        return f"{g[0]}.gamma", v
    return None


def _is_mae(tree: Mapping) -> bool:
    """A ContextCast subtree (the ViT's shares its patch-embedding names)."""
    return isinstance(tree, Mapping) and "class_token" in tree


def _film_key(parts: list[str], v: np.ndarray, mae: bool = False):
    """(name, array) of a GCN, ViT or MAE generator leaf or of the MAE film
    head, or None; `mae`: the generator is a ContextCast."""
    if parts[:2] == ["film_gen", "film_head"] and len(parts) == 4:
        return f"film_gen.film_head.net.{_FF[parts[2]]}.{_kind(parts[3])}", _linear(parts[3], v)
    if parts[:2] != ["film_gen", "film_gen"] or len(parts) < 3:
        return None
    if mae:
        hit = _mae_key(parts[2:], v)
        return None if hit is None else (f"film_gen.film_gen.{hit[0]}", hit[1])
    layer, g = parts[2], parts[3:]
    base = f"film_gen.film_gen.{layer}"
    if layer == "head_film":
        return f"{base}.{_kind(g[0])}", _linear(g[0], v)
    if re.match(r"^conv(1|_\d+)$", layer):
        if g == ["weight", "kernel"]:
            return f"{base}.weight", v
        if g == ["bias"]:
            return f"{base}.bias", v
        return None
    hit = _vit_key(parts[2:], v)
    return None if hit is None else (f"film_gen.film_gen.{hit[0]}", hit[1])


def _convert(params: Mapping, key) -> dict[str, torch.Tensor]:
    """state_dict of a flax tree through `key(parts, array)` -> (name,
    array) or None; raises on a leaf it cannot place."""
    out, unknown = {}, []
    for path, v in _flatten(params).items():
        hit = key(path.split("/"), v)
        if hit is None:
            unknown.append(path)
            continue
        name, arr = hit
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32))
    if unknown:
        raise ValueError(f"unmapped parameters: {unknown}")
    return out


def from_flax_params(params: Mapping) -> dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (a flax `params` tree of the JAX SFNO /
    filmed SFNO with a gcn, gcn_custom, transformer or mae generator) ->
    state_dict for `load_state_dict(strict=True)`.  Raises on a leaf it
    cannot place."""
    mae = _is_mae(params.get("film_gen", {}).get("film_gen"))
    return _convert(params, lambda parts, v: _backbone_key(parts, v)
                    or _film_key(parts, v, mae))


def from_flax_mae_params(params: Mapping) -> dict[str, torch.Tensor]:
    """A `MAEWrapper` tree (ContextCast at its top level) or a linear
    probe's (`head`, Dense (embed_dim, 1)) -> its state_dict."""
    def key(parts, v):
        if parts[0] == "head" and len(parts) == 2:
            return f"head.{_kind(parts[1])}", _linear(parts[1], v)
        return _mae_key(parts, v)

    return _convert(params, key)


def _afno_key(parts: list[str], v: np.ndarray, patch_size: tuple[int, int]):
    """(reference name, array) of an AFNONet leaf, or None."""
    ph, pw = patch_size
    if parts == ["pos_embed"]:  # (gh, gw, D) -> (1, N, D)
        return "pos_embed", v.reshape(1, -1, v.shape[-1])
    if parts == ["patch_embed", "kernel"]:  # ((ph pw C), D) -> (D, C, ph, pw)
        d = v.shape[-1]
        return "patch_embed.proj.weight", np.ascontiguousarray(
            np.transpose(v.reshape(ph, pw, -1, d), (3, 2, 0, 1)))
    if parts == ["patch_embed", "bias"]:
        return "patch_embed.proj.bias", v
    if parts == ["head", "kernel"]:
        return "head.weight", _linear("kernel", v)
    m = re.match(r"^blocks_(\d+)$", parts[0])
    if not m or len(parts) != 3:
        return None
    base, (sub, leaf) = f"blocks.{m.group(1)}", parts[1:]
    if sub in ("norm1", "norm2"):
        return f"{base}.{sub}.{_kind(leaf)}", v
    if sub == "filter" and leaf in ("w1", "b1", "w2", "b2"):
        return f"{base}.filter.{leaf}", v
    if sub in ("mlp_fc1", "mlp_fc2"):
        return f"{base}.mlp.fc{sub[-1]}.{_kind(leaf)}", _linear(leaf, v)
    return None


def from_flax_afno_params(params: Mapping,
                          patch_size: tuple[int, int] = (8, 8)) -> dict[str, torch.Tensor]:
    """A flax AFNONet tree, or a PrecipNet's ({"backbone": ..., "conv":
    ...}), -> the reference FourCastNet state_dict (PrecipNet's backbone
    under "backbone.", its conv (kh, kw, I, O) as (O, I, kh, kw))."""
    def key(parts, v):
        if parts[0] == "conv" and len(parts) == 2:
            if parts[1] == "kernel":
                return "conv.weight", np.ascontiguousarray(np.transpose(v, (3, 2, 0, 1)))
            return "conv.bias", v
        if parts[0] == "backbone":
            hit = _afno_key(parts[1:], v, patch_size)
            return None if hit is None else (f"backbone.{hit[0]}", hit[1])
        return _afno_key(parts, v, patch_size)

    return _convert(params, key)


def from_flax_train_state(trainable: Mapping, frozen: Mapping) -> dict[str, torch.Tensor]:
    """The `trainable` and `frozen` trees of a JAX `TrainState` (numpy
    arrays; bf16 frozen leaves are widened to fp32) -> one state_dict for
    the trainer's model (`load_state_dict(strict=True)`)."""
    return {**from_flax_params(frozen), **from_flax_params(trainable)}
