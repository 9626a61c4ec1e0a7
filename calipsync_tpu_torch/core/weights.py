"""Generator and HuBERT weights carried across from the JAX package
(HuBERT: :func:`from_jax_hubert` and :func:`random_jax_hubert`, at the end
of this file).

:func:`from_jax_generator` takes the JAX ``{'params', 'batch_stats'}`` tree
(nested dicts of numpy arrays) and returns the port's state_dict, which has
the reference torch key set (582 keys for hubert with 4 blocks) and loads
into :class:`calipsync_tpu_torch.nn.unet.Generator` with ``strict=True``.
It is the port's own copy of calipsync_tpu/core/weights_export.py:30-148:

  flax conv kernel (kh, kw, I, O) -> torch Conv2d weight (O, I, kh, kw)
  flax dense kernel (I, O)        -> torch Linear weight (O, I)
  flax bn scale/bias + batch_stats mean/var -> torch BN
  weight/bias/running_mean/running_var (+ zero num_batches_tracked)

The JAX import folds the pre-BN conv biases of audio_model.conv3/conv5
into the BN running mean (mean' = mean - bias, bit-exact), so those two
biases come across as zeros beside the folded mean.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from calipsync_tpu_torch.nn.unet import CH


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _conv_kernel(k) -> torch.Tensor:
    """flax (kh, kw, I, O) -> torch (O, I, kh, kw)."""
    return _t(np.asarray(k, np.float32).transpose(3, 2, 0, 1))


def _bn(out: Dict, p: str, params: Mapping, stats: Mapping) -> None:
    out[f"{p}.weight"] = _t(params["scale"])
    out[f"{p}.bias"] = _t(params["bias"])
    out[f"{p}.running_mean"] = _t(stats["mean"])
    out[f"{p}.running_var"] = _t(stats["var"])
    out[f"{p}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


def _conv_bn(out: Dict, conv_p: str, bn_p: str, params: Mapping,
             stats: Mapping, conv_has_bias: bool = False) -> None:
    out[f"{conv_p}.weight"] = _conv_kernel(params["conv"]["kernel"])
    if conv_has_bias:
        out[f"{conv_p}.bias"] = torch.zeros(out[f"{conv_p}.weight"].shape[0])
    _bn(out, bn_p, params["bn"], stats["bn"])


def _ir(out: Dict, p: str, params: Mapping, stats: Mapping) -> None:
    """InvertedResidual Sequential indices 0/1, 3/4, 6/7 (bias=False)."""
    for name, ci, bi in (("expand", 0, 1), ("depthwise", 3, 4),
                         ("project", 6, 7)):
        _conv_bn(out, f"{p}.conv.{ci}", f"{p}.conv.{bi}", params[name],
                 stats[name])


def _double_conv(out: Dict, p: str, params: Mapping,
                 stats: Mapping) -> None:
    for name, i in (("ir1", 0), ("ir2", 1)):
        _ir(out, f"{p}.double_conv.{i}", params[name], stats[name])


def _conv_bias(out: Dict, p: str, params: Mapping) -> None:
    out[f"{p}.weight"] = _conv_kernel(params["kernel"])
    if "bias" in params:
        out[f"{p}.bias"] = _t(params["bias"])


def _dense(out: Dict, p: str, params: Mapping) -> None:
    out[f"{p}.weight"] = _t(np.asarray(params["kernel"], np.float32).T)
    if "bias" in params:
        out[f"{p}.bias"] = _t(params["bias"])


def _audio(out: Dict, p: str, params: Mapping, stats: Mapping,
           mode: str) -> None:
    """Audio encoder keys under prefix ``p`` (AudioConvHubert/Wenet)."""
    for name in ("conv1", "conv2", "conv4", "conv6", "conv7"):
        _ir(out, f"{p}{name}", params[name], stats[name])
    for conv in ("conv3", "conv5"):
        _conv_bn(out, f"{p}{conv}", f"{p}bn{conv[-1]}", params[conv],
                 stats[conv], conv_has_bias=True)
    if mode == "hubert":
        _bn(out, f"{p}bn7", params["bn7"], stats["bn7"])


def from_jax_generator(variables: Mapping, mode: str = "hubert",
                       n_blocks: int = 4) -> Dict[str, torch.Tensor]:
    """{'params', 'batch_stats'} JAX generator tree -> the port's
    state_dict (fp32 torch tensors, reference key names)."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, torch.Tensor] = {}

    _ir(out, "inc.inconv.0", params["inc"]["ir"], stats["inc"]["ir"])
    for i in range(1, 5):
        _double_conv(out, f"down{i}.maxpool_conv.0",
                     params[f"down{i}"]["conv"], stats[f"down{i}"]["conv"])

    _audio(out, "audio_model.", params["audio_model"],
           stats["audio_model"], mode)

    for name in ("fc1", "fc2"):
        _dense(out, f"mlp_fusion.{name}", params["mlp_fusion"][name])
    for name in ("bn1", "bn2"):
        _bn(out, f"mlp_fusion.{name}", params["mlp_fusion"][name],
            stats["mlp_fusion"][name])

    for name in ("bn_tx", "bn_kx", "outc_bn"):
        _bn(out, name, params[name], stats[name])

    for i in range(n_blocks):
        p = params[f"attention_blocks_{i}"]
        s = stats[f"attention_blocks_{i}"]
        tp = f"attention_blocks.{i}"
        _conv_bias(out, f"{tp}.attention_adjust_p_1", p["proj_in"])
        _conv_bias(out, f"{tp}.attention_adjust_b_1", p["proj_out"])
        for torch_name, jax_name in (("query_conv", "query"),
                                     ("key_conv", "key"),
                                     ("value_conv", "value")):
            _conv_bias(out, f"{tp}.cross_attention.{torch_name}",
                       p["attn"][jax_name])
        out[f"{tp}.cross_attention.gamma"] = _t(p["attn"]["gamma"])
        _bn(out, f"{tp}.bn", p["bn"], s["bn"])

    for name, i in (("fuse_conv1", 0), ("fuse_conv2", 1)):
        _double_conv(out, f"fuse_conv.{i}", params[name], stats[name])
    for i in range(1, 5):
        _double_conv(out, f"up{i}.conv", params[f"up{i}"]["conv"],
                     stats[f"up{i}"]["conv"])

    _conv_bias(out, "outc.conv", params["outc"]["conv"])
    return out


def random_jax_generator(n_blocks: int = 4, seed: int = 0) -> Dict:
    """A random hubert generator in the JAX layout ({'params',
    'batch_stats'}, nested dicts of numpy arrays): what
    :func:`from_jax_generator` takes, made with numpy from ``seed``.

    Every leaf is random, and scaled so that every layer reaches the output
    and the sigmoid stays unsaturated: conv and dense kernels
    N(0, (1.2 / sqrt(fan_in))^2), the output conv's at a quarter of that;
    BN scales U(0.8, 1.2), variances U(0.5, 1.5), means and all biases
    N(0, 0.1); attention gammas U(0.5, 1.0), where the JAX init's zeros
    would cut the attention off. (N(0, 0.1) for every kernel shrinks the
    signal about 100x a block, and the output then ignores the audio.)
    """
    rng = np.random.default_rng(seed)

    def normal(*shape, std=0.1):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def uniform(lo, hi, *shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def kernel(*shape, scale=1.0):  # fan-in: every axis but the last
        return normal(*shape, std=1.2 * scale / np.sqrt(np.prod(shape[:-1])))

    def bn(c):
        return ({"scale": uniform(0.8, 1.2, c), "bias": normal(c)},
                {"mean": normal(c), "var": uniform(0.5, 1.5, c)})

    def conv_bn(k, cin, cout, groups=1):
        p, s = bn(cout)
        return ({"conv": {"kernel": kernel(k, k, cin // groups, cout)},
                 "bn": p}, {"bn": s})

    def conv_bias(cin, cout, scale=1.0):
        return {"kernel": kernel(1, 1, cin, cout, scale=scale),
                "bias": normal(cout)}

    def dense(cin, cout):
        return {"kernel": kernel(cin, cout), "bias": normal(cout)}

    def tree(**parts):  # name -> (params, stats) pairs, stats may be None
        return ({k: v[0] for k, v in parts.items()},
                {k: v[1] for k, v in parts.items() if v[1] is not None})

    def ir(inp, oup):
        hid = inp * 2
        return tree(expand=conv_bn(1, inp, hid),
                    depthwise=conv_bn(3, hid, hid, groups=hid),
                    project=conv_bn(1, hid, oup))

    def double(inp, oup):
        return tree(ir1=ir(inp, oup), ir2=ir(oup, oup))

    def wrap(name, part):
        return tree(**{name: part})

    ch = CH

    def attention_block():
        p, s = bn(2 * ch[4])
        return ({"proj_in": conv_bias(2 * ch[4], ch[4]),
                 "attn": {"query": conv_bias(ch[4], ch[4] // 8),
                          "key": conv_bias(ch[4], ch[4] // 8),
                          "value": conv_bias(ch[4], ch[4]),
                          "gamma": uniform(0.5, 1.0, 1)},
                 "proj_out": conv_bias(ch[4], 2 * ch[4]), "bn": p},
                {"bn": s})

    params, stats = tree(
        inc=wrap("ir", ir(6, ch[0])),
        **{f"down{i + 1}": wrap("conv", double(ch[i], ch[i + 1]))
           for i in range(4)},
        audio_model=tree(conv1=ir(32, ch[1]), conv2=ir(ch[1], ch[2]),
                         conv3=conv_bn(3, ch[2], ch[3]),
                         conv4=ir(ch[3], ch[3]),
                         conv5=conv_bn(3, ch[3], ch[4]),
                         conv6=ir(ch[4], ch[4]), conv7=ir(ch[4], ch[4]),
                         bn7=bn(ch[4])),
        mlp_fusion=tree(fc1=(dense(2 * ch[4], 2 * ch[4]), None),
                        bn1=bn(2 * ch[4]),
                        fc2=(dense(2 * ch[4], 2 * ch[4]), None),
                        bn2=bn(2 * ch[4])),
        bn_tx=bn(2 * ch[4]),
        **{f"attention_blocks_{i}": attention_block()
           for i in range(n_blocks)},
        bn_kx=bn(2 * ch[4]),
        fuse_conv1=double(2 * ch[4], ch[4]), fuse_conv2=double(ch[4], ch[3]),
        up1=wrap("conv", double(ch[4], ch[3] // 2)),
        up2=wrap("conv", double(ch[3], ch[2] // 2)),
        up3=wrap("conv", double(ch[2], ch[1] // 2)),
        up4=wrap("conv", double(ch[1], ch[0])),
        outc=({"conv": conv_bias(ch[0], 3, scale=0.25)}, None),
        outc_bn=bn(3))
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------- HuBERT

def from_jax_hubert(variables: Mapping, config) -> Dict[str, torch.Tensor]:
    """flax HuBERT variables ({'params': ...}, numpy leaves, the layout of
    calipsync_tpu/nn/hubert.py) -> the port's state_dict (HF
    ``HubertModel`` keys), strict-loadable into
    :class:`calipsync_tpu_torch.nn.hubert.HubertModel` built from the same
    ``config`` (a :class:`~calipsync_tpu_torch.nn.hubert.HubertConfig`).

    The inverse of the JAX ``import_hubert``: conv kernels (K, I, O) ->
    (O, I, K), dense kernels transposed, the per-head q/k/v (hidden, H, D)
    and out (H, D, hidden) kernels flattened. The positional conv's folded
    kernel becomes the weight-norm pair v = w, g = |w| (computed as the
    forward computes it, so g / |v| is 1). A conv bias the flax tree lacks
    (the 'group' extractor's layers after the first) comes across as
    zeros; ``masked_spec_embed`` (unused at inference) as zeros.
    """
    from calipsync_tpu_torch.nn.hubert import _tap_norm

    p = variables["params"]
    out: Dict[str, torch.Tensor] = {}
    hidden = config.hidden_size
    out["masked_spec_embed"] = torch.zeros(hidden)

    fe = p["feature_extractor"]
    for i in range(len(config.conv_dim)):
        base = f"feature_extractor.conv_layers.{i}"
        conv = fe[f"conv{i}"]
        w = _t(np.asarray(conv["kernel"], np.float32).transpose(2, 1, 0))
        out[f"{base}.conv.weight"] = w
        if config.conv_bias:
            out[f"{base}.conv.bias"] = (_t(conv["bias"]) if "bias" in conv
                                        else torch.zeros(w.shape[0]))
        norm = (fe.get(f"ln{i}") if config.feat_extract_norm == "layer"
                else fe.get("gn0") if i == 0 else None)
        if norm is not None:
            _layer_norm(out, f"{base}.layer_norm", norm)

    fp = p["feature_projection"]
    _layer_norm(out, "feature_projection.layer_norm", fp["layer_norm"])
    _dense(out, "feature_projection.projection", fp["projection"])

    enc = p["encoder"]
    pc = enc["pos_conv_embed"]["conv"]
    v = _t(np.asarray(pc["kernel"], np.float32).transpose(2, 1, 0))
    out["encoder.pos_conv_embed.conv.bias"] = _t(pc["bias"])
    out["encoder.pos_conv_embed.conv.weight_g"] = _tap_norm(v)
    out["encoder.pos_conv_embed.conv.weight_v"] = v
    _layer_norm(out, "encoder.layer_norm", enc["layer_norm"])
    for i in range(config.num_hidden_layers):
        lp = enc[f"layers_{i}"]
        base = f"encoder.layers.{i}"
        att = lp["attention"]
        for name in ("q_proj", "k_proj", "v_proj"):
            k = np.asarray(att[name]["kernel"], np.float32)
            out[f"{base}.attention.{name}.weight"] = _t(
                k.reshape(hidden, -1).T)
            out[f"{base}.attention.{name}.bias"] = _t(
                np.asarray(att[name]["bias"]).reshape(-1))
        k = np.asarray(att["out_proj"]["kernel"], np.float32)
        out[f"{base}.attention.out_proj.weight"] = _t(
            k.reshape(-1, hidden).T)
        out[f"{base}.attention.out_proj.bias"] = _t(att["out_proj"]["bias"])
        _layer_norm(out, f"{base}.layer_norm", lp["layer_norm"])
        for name in ("intermediate_dense", "output_dense"):
            _dense(out, f"{base}.feed_forward.{name}",
                   lp["feed_forward"][name])
        _layer_norm(out, f"{base}.final_layer_norm", lp["final_layer_norm"])
    return out


def _layer_norm(out: Dict, p: str, params: Mapping) -> None:
    out[f"{p}.weight"] = _t(params["scale"])
    out[f"{p}.bias"] = _t(params["bias"])


def random_jax_hubert(config, seed: int = 0) -> Dict:
    """Random HuBERT variables in the flax layout ({'params': ...}, numpy
    leaves): what :func:`from_jax_hubert` takes, made with numpy from
    ``seed`` (no JAX needed).

    Kernels N(0, 1/fan_in), the init flax's lecun_normal gives; biases
    N(0, 0.02); norm scales U(0.9, 1.1) and biases N(0, 0.02). The
    pre-LN residual stream then neither saturates nor collapses over 24
    layers: each sublayer adds an O(1) update to an O(1) stream.
    """
    rng = np.random.default_rng(seed)
    c = config
    h = c.num_attention_heads
    d = c.hidden_size // h

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def kernel(*shape, fan_in):
        return normal(shape, fan_in ** -0.5)

    def bias(n):
        return normal((n,), 0.02)

    def norm(n):
        return {"scale": rng.uniform(0.9, 1.1, n).astype(np.float32),
                "bias": bias(n)}

    def dense(i, o):
        return {"kernel": kernel(i, o, fan_in=i), "bias": bias(o)}

    fe = {}
    cin = 1
    for i, (dim, k) in enumerate(zip(c.conv_dim, c.conv_kernel)):
        conv = {"kernel": kernel(k, cin, dim, fan_in=k * cin)}
        if c.conv_bias and (c.feat_extract_norm == "layer" or i == 0):
            conv["bias"] = bias(dim)
        fe[f"conv{i}"] = conv
        if c.feat_extract_norm == "layer":
            fe[f"ln{i}"] = norm(dim)
        elif i == 0:
            fe["gn0"] = norm(dim)
        cin = dim

    k, g = c.num_conv_pos_embeddings, c.num_conv_pos_embedding_groups
    enc = {"pos_conv_embed": {"conv": {
               "kernel": kernel(k, c.hidden_size // g, c.hidden_size,
                                fan_in=k * c.hidden_size // g),
               "bias": bias(c.hidden_size)}},
           "layer_norm": norm(c.hidden_size)}
    for i in range(c.num_hidden_layers):
        def qkv():
            return {"kernel": kernel(c.hidden_size, h, d,
                                     fan_in=c.hidden_size),
                    "bias": normal((h, d), 0.02)}

        enc[f"layers_{i}"] = {
            "attention": {"q_proj": qkv(), "k_proj": qkv(), "v_proj": qkv(),
                          "out_proj": {"kernel": kernel(h, d, c.hidden_size,
                                                        fan_in=c.hidden_size),
                                       "bias": bias(c.hidden_size)}},
            "layer_norm": norm(c.hidden_size),
            "final_layer_norm": norm(c.hidden_size),
            "feed_forward": {
                "intermediate_dense": dense(c.hidden_size,
                                            c.intermediate_size),
                "output_dense": dense(c.intermediate_size, c.hidden_size)}}
    return {"params": {
        "feature_extractor": fe,
        "feature_projection": {"layer_norm": norm(c.conv_dim[-1]),
                               "projection": dense(c.conv_dim[-1],
                                                   c.hidden_size)},
        "encoder": enc}}
