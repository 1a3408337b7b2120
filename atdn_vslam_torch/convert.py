"""JAX variables -> port ``state_dict``: the inverse of
``tools/convert_torch_checkpoint.py`` (reference ``.pth`` -> flax).

Input trees are nested dicts of arrays, ``{"params": ..., "batch_stats":
...}`` as flax's ``init`` returns them; outputs are ``state_dict``s of
CPU float32 tensors with the reference's key names, which load into
:class:`~atdn_vslam_torch.models.flow.network.RAFTGMA`,
:class:`~atdn_vslam_torch.models.odometry.ATDNVO` and
:class:`~atdn_vslam_torch.models.mapping.MappingVAE` with ``strict=True``.
What is inverted:

  * conv kernels (kH, kW, I, O) -> (O, I, kH, kW), dense (I, O) -> (O, I);
  * batch norm scale/bias/mean/var -> weight/bias/running_mean/
    running_var (plus ``num_batches_tracked``);
  * the JAX SepConvGRU's fused z|r conv -> separate ``convz``/``convr``;
  * flax's per-gate LSTM denses -> packed (i, f, g, o) ``weight_ih``/
    ``weight_hh``, the whole bias on ``bias_hh`` and zeros on ``bias_ih``;
  * the ATDNVO Linear's input order, HWC (JAX) -> CHW (reference);
  * flax ``LayerNorm`` scale/bias -> ``norm.weight``/``norm.bias``;
  * the correlation window of ``convc1``'s input channels, dy-major
    (JAX) -> dx-major (reference);
  * the positional tables ``AttentionQK_0/RelPosEmb_0/rel_height`` and
    ``rel_width`` -> ``att.pos_emb.rel_height.weight`` and
    ``att.pos_emb.rel_width.weight``, unchanged;
  * flax's ``nn.ConvTranspose`` kernel (kH, kW, I, O), which correlates
    the dilated input with the kernel as stored, -> torch's
    ``ConvTranspose2d`` weight (I, O, kH, kW), which flips it spatially:
    the map flips kH and kW.
"""

from __future__ import annotations

import numpy as np
import torch

from atdn_vslam_torch.models.odometry import NON_COMPRESSOR_CHANNELS, encoder_feature_shape


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(_np(x)))


def _conv(k) -> torch.Tensor:
    return _t(np.transpose(_np(k), (3, 2, 0, 1)))


def _dense(k) -> torch.Tensor:
    return _t(np.transpose(_np(k), (1, 0)))


def _put_conv(sd: dict, key: str, node: dict) -> None:
    sd[f"{key}.weight"] = _conv(node["kernel"])
    if "bias" in node:
        sd[f"{key}.bias"] = _t(node["bias"])


def _put_bn(sd: dict, key: str, params: dict, stats: dict) -> None:
    sd[f"{key}.weight"] = _t(params["scale"])
    sd[f"{key}.bias"] = _t(params["bias"])
    sd[f"{key}.running_mean"] = _t(stats["mean"])
    sd[f"{key}.running_var"] = _t(stats["var"])
    sd[f"{key}.num_batches_tracked"] = torch.tensor(0)


def corr_window_perm(levels: int = 4, radius: int = 4) -> np.ndarray:
    """perm[jax_channel] = reference_channel for the lookup output; the
    permutation is its own inverse (a transpose within each level)."""
    span = 2 * radius + 1
    block = np.arange(span * span).reshape(span, span).T.reshape(-1)
    return np.concatenate([block + level * span * span for level in range(levels)])


# ---------------------------------------------------------------------
# GMA / RAFTGMA
# ---------------------------------------------------------------------


def _gma_encoder(sd, key: str, params: dict, stats: dict | None) -> None:
    _put_conv(sd, f"{key}.conv1", params["Conv_0"])
    if stats is not None:
        _put_bn(sd, f"{key}.norm1", params["_Norm_0"]["BatchNorm_0"],
                stats["_Norm_0"]["BatchNorm_0"])
    for layer in range(3):
        for j in range(2):
            blk = f"ResidualBlock_{layer * 2 + j}"
            p = params[blk]
            tkey = f"{key}.layer{layer + 1}.{j}"
            _put_conv(sd, f"{tkey}.conv1", p["Conv_0"])
            _put_conv(sd, f"{tkey}.conv2", p["Conv_1"])
            if stats is not None:
                s = stats[blk]
                _put_bn(sd, f"{tkey}.norm1", p["_Norm_0"]["BatchNorm_0"], s["_Norm_0"]["BatchNorm_0"])
                _put_bn(sd, f"{tkey}.norm2", p["_Norm_1"]["BatchNorm_0"], s["_Norm_1"]["BatchNorm_0"])
            if "Conv_2" in p:
                _put_conv(sd, f"{tkey}.downsample.0", p["Conv_2"])
                if stats is not None:
                    for name in ("norm3", "downsample.1"):
                        _put_bn(sd, f"{tkey}.{name}", p["_Norm_2"]["BatchNorm_0"],
                                s["_Norm_2"]["BatchNorm_0"])
    _put_conv(sd, f"{key}.conv2", params["Conv_1"])


def gma_state_dict_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """RAFTGMA flax variables -> port/reference ``state_dict``."""
    params, stats = tree["params"], tree.get("batch_stats", {})
    sd: dict[str, torch.Tensor] = {}
    _gma_encoder(sd, "fnet", params["BasicEncoder_0"], None)
    _gma_encoder(sd, "cnet", params["BasicEncoder_1"], stats["BasicEncoder_1"])
    sd["att.to_qk.weight"] = _conv(params["AttentionQK_0"]["Conv_0"]["kernel"])
    pos = params["AttentionQK_0"].get("RelPosEmb_0")
    if pos is not None:  # the positional modes: (2 max_pos - 1, dim_head) tables as they are
        sd["att.pos_emb.rel_height.weight"] = _t(pos["rel_height"])
        sd["att.pos_emb.rel_width.weight"] = _t(pos["rel_width"])

    up = params["update"]["GMAUpdateBlock_0"]
    enc = up["BasicMotionEncoder_0"]
    convc1 = _np(enc["Conv_0"]["kernel"])
    levels = convc1.shape[2] // 81
    convc1 = convc1[:, :, corr_window_perm(levels, 4), :]
    sd["update_block.encoder.convc1.weight"] = _conv(convc1)
    sd["update_block.encoder.convc1.bias"] = _t(enc["Conv_0"]["bias"])
    for fname, tname in (("Conv_1", "convc2"), ("Conv_2", "convf1"),
                         ("Conv_3", "convf2"), ("Conv_4", "conv")):
        _put_conv(sd, f"update_block.encoder.{tname}", enc[fname])

    agg = up["Aggregate_0"]
    sd["update_block.aggregator.to_v.weight"] = _conv(agg["Conv_0"]["kernel"])
    sd["update_block.aggregator.gamma"] = _t(agg["gamma"]).reshape(1)

    gru = up["SepConvGRU_0"]
    for d in (1, 2):
        zr = gru[f"Conv_{2 * (d - 1)}"]
        kz, kr = np.split(_np(zr["kernel"]), 2, axis=-1)
        bz, br = np.split(_np(zr["bias"]), 2)
        sd[f"update_block.gru.convz{d}.weight"] = _conv(kz)
        sd[f"update_block.gru.convz{d}.bias"] = _t(bz)
        sd[f"update_block.gru.convr{d}.weight"] = _conv(kr)
        sd[f"update_block.gru.convr{d}.bias"] = _t(br)
        _put_conv(sd, f"update_block.gru.convq{d}", gru[f"Conv_{2 * d - 1}"])
    for fname, tname in (("Conv_0", "conv1"), ("Conv_1", "conv2")):
        _put_conv(sd, f"update_block.flow_head.{tname}", up["FlowHead_0"][fname])
    _put_conv(sd, "update_block.mask.0", up["mask_conv1"])
    _put_conv(sd, "update_block.mask.2", up["mask_conv2"])
    return sd


# ---------------------------------------------------------------------
# ATDNVO
# ---------------------------------------------------------------------


def _conv_block(sd, key: str, params: dict, stats: dict) -> None:
    _put_conv(sd, f"{key}.conv", params["Conv_0"])
    _put_bn(sd, f"{key}.bn", params["BatchNorm_0"], stats["BatchNorm_0"])


def _residual_block(sd, key: str, params: dict, stats: dict) -> None:
    _conv_block(sd, f"{key}.conv.0", params["ConvBlock_0"], stats["ConvBlock_0"])
    _conv_block(sd, f"{key}.conv.1", params["ConvBlock_1"], stats["ConvBlock_1"])
    _put_conv(sd, f"{key}.skip_layer", params["Conv_0"])
    _put_bn(sd, f"{key}.out_block.1", params["BatchNorm_0"], stats["BatchNorm_0"])


def _lstm(sd, key: str, params: dict) -> None:
    gates = "ifgo"
    sd[f"{key}.weight_ih"] = _t(np.concatenate([_np(params[f"i{g}"]["kernel"]).T for g in gates]))
    sd[f"{key}.weight_hh"] = _t(np.concatenate([_np(params[f"h{g}"]["kernel"]).T for g in gates]))
    bias = np.concatenate([_np(params[f"h{g}"]["bias"]) for g in gates])
    sd[f"{key}.bias_ih"] = torch.zeros(bias.shape)
    sd[f"{key}.bias_hh"] = _t(bias)


def _linear(sd, key: str, params: dict) -> None:
    sd[f"{key}.weight"] = _dense(params["kernel"])
    if "bias" in params:
        sd[f"{key}.bias"] = _t(params["bias"])


def _linear_block(sd, key: str, params: dict, kernel=None) -> None:
    """A LinearBlock's dense (``kernel`` overrides its kernel) and, when
    it has one, its layer norm."""
    dense = params["Dense_0"]
    _linear(sd, f"{key}.linear", dense if kernel is None else {"kernel": kernel, "bias": dense["bias"]})
    if "LayerNorm_0" in params:
        sd[f"{key}.norm.weight"] = _t(params["LayerNorm_0"]["scale"])
        sd[f"{key}.norm.bias"] = _t(params["LayerNorm_0"]["bias"])


def atdnvo_state_dict_from_jax(
    tree: dict, image_hw: tuple[int, int] = (376, 1232)
) -> dict[str, torch.Tensor]:
    """ATDNVO flax variables -> port/reference ``state_dict``, for the
    compressor and the non-compressor encoder, with or without layer
    norms (the variant is read from the tree; dropout has no parameter).

    :param image_hw: the flow size the model was built for; it fixes
        the (C, H, W) of the flattened encoder features.
    """
    params, stats = tree["params"], tree["batch_stats"]
    enc, enc_s = params["encoder"], stats["encoder"]
    compressor = "ConvBlock_0" in enc
    sd: dict[str, torch.Tensor] = {}
    if compressor:
        _put_conv(sd, "encoder_CNN.0", enc["Conv_0"])
        _conv_block(sd, "encoder_CNN.1", enc["ConvBlock_0"], enc_s["ConvBlock_0"])
        for i in range(4):
            name = f"ResidualConvBlock_{i}"
            _residual_block(sd, f"encoder_CNN.{i + 2}", enc[name], enc_s[name])
        _conv_block(sd, "encoder_CNN.6", enc["ConvBlock_1"], enc_s["ConvBlock_1"])
        linear_key = "encoder_CNN.8"
    else:
        for i in range(len(NON_COMPRESSOR_CHANNELS)):
            name = f"ResidualConvBlock_{i}"
            _residual_block(sd, f"encoder_CNN.{i}", enc[name], enc_s[name])
        linear_key = f"encoder_CNN.{len(NON_COMPRESSOR_CHANNELS) + 1}"
    # JAX flattens (H, W, C), the reference (C, H, W)
    c, h, w = encoder_feature_shape(image_hw, compressor)
    block = enc["LinearBlock_0"]
    kernel = _np(block["Dense_0"]["kernel"]).reshape(h, w, c, -1).transpose(2, 0, 1, 3).reshape(c * h * w, -1)
    _linear_block(sd, linear_key, block, kernel)
    _lstm(sd, "lstm1", params["lstm1"])
    _linear_block(sd, "lstm_linear", params["lstm_linear"])
    _lstm(sd, "lstm2", params["lstm2"])
    for jax_head, ref_head in (("rotation_head", "rotation_regressor"),
                               ("translation_head", "translation_regressor")):
        head = params[jax_head]
        _linear_block(sd, f"{ref_head}.0", head["LinearBlock_0"])
        _linear_block(sd, f"{ref_head}.1", head["LinearBlock_1"])
        _linear(sd, f"{ref_head}.2", head["Dense_0"])
    return sd


# ---------------------------------------------------------------------
# MappingVAE
# ---------------------------------------------------------------------


def _transposed_conv_block(sd, key: str, params: dict, stats: dict) -> None:
    _conv_block(sd, f"{key}.conv", params["ConvBlock_0"], stats["ConvBlock_0"])
    tconv = params["ConvTranspose_0"]
    # flax correlates with the kernel as stored, torch flips it
    sd[f"{key}.tconv.weight"] = _t(np.transpose(_np(tconv["kernel"])[::-1, ::-1], (2, 3, 0, 1)))
    sd[f"{key}.tconv.bias"] = _t(tconv["bias"])
    _put_bn(sd, f"{key}.bn", params["BatchNorm_0"], stats["BatchNorm_0"])
    _put_conv(sd, f"{key}.skip_layer", params["Conv_0"])
    _put_bn(sd, f"{key}.out_block.1", params["BatchNorm_1"], stats["BatchNorm_1"])


def mapping_state_dict_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """MappingVAE flax variables -> port ``state_dict``."""
    params, stats = tree["params"], tree["batch_stats"]
    sd: dict[str, torch.Tensor] = {}
    _conv_block(sd, "stem", params["stem"], stats["stem"])
    downs = sorted((k for k in params if k.startswith("down_")), key=lambda k: int(k[5:]))
    for i, name in enumerate(downs):
        _residual_block(sd, f"down.{i}", params[name], stats[name])
    _put_conv(sd, "mean_lin", params["mean_lin"])
    if "sigma_lin" in params:
        _put_conv(sd, "sigma_lin", params["sigma_lin"])
    ups = sorted((k for k in params if k.startswith("up_")), key=lambda k: int(k[3:]))
    for i, name in enumerate(ups):
        _transposed_conv_block(sd, f"up.{i}", params[name], stats[name])
    _put_conv(sd, "out_conv", params["out_conv"])
    return sd
