"""The port's model parallelism (core/tp.py, core/pp.py, core/ep.py, the
extractor's ``mesh``/``parallel`` modes) and its dry run
(``dryrun.py``) against the JAX package on the CPU.

JAX runs on the conftest's 8 virtual devices; the port on one group of 4
gloo ranks spawned once for the module (``core.mesh.launch``, the rank
code in ``tests/_torch_ranks.py``), the JAX references computed in the
parent meanwhile. A tiny HuBERT (2 layers, 4 heads, the JAX tests' chunk
arithmetic) with random weights carried across by ``from_jax_hubert``;
inputs from numpy seeds. Tolerances: pipelined and expert-parallel runs
against their one-device math at the JAX package's own bar for them
(tests/test_pp.py, tests/test_ep.py), rtol 2e-5 / atol 2e-6; everything
against JAX, and TP (a sum of partial products), at the repo's bar,
rtol 1e-3 / atol 1e-5.
"""

import dataclasses
import json
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from calipsync_tpu.audio.hubert_pipeline import \
    HubertFeatureExtractor as JaxExtractor
from calipsync_tpu.core import ep as jax_ep
from calipsync_tpu.core.pp import hubert_pp_apply as jax_pp_apply
from calipsync_tpu.core.tp import hubert_tp_specs as jax_tp_specs
from calipsync_tpu.nn import hubert as jax_hubert
from calipsync_tpu_torch import cli, dryrun
from calipsync_tpu_torch.audio.hubert_pipeline import HubertFeatureExtractor
from calipsync_tpu_torch.audio.io import save_wav
from calipsync_tpu_torch.core import ep, mesh as meshlib
from calipsync_tpu_torch.core.pp import hubert_pp_apply, stack_encoder_layers
from calipsync_tpu_torch.core.tp import hubert_tp_specs, shard_hubert
from calipsync_tpu_torch.core.weights import (from_jax_hubert,
                                              random_jax_hubert)
from calipsync_tpu_torch.nn.hubert import (FeedForward, HubertConfig,
                                           HubertModel, EncoderLayer)

import _torch_ranks as ranks

RTOL, ATOL = 1e-3, 1e-5
PP_TOL = dict(rtol=2e-5, atol=2e-6)
TINY = dict(hidden_size=24, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=48, conv_dim=(16, 16, 16),
            conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2), conv_bias=True,
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
CHUNKING = dict(bucket_samples=500, kernel=30, stride=20, clip_samples=1000)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(out, ref, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=msg)


def _jax_references(jcfg, variables, a):
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    model = jax_hubert.HubertModel(jcfg)
    frames = jnp.asarray([jcfg.num_frames(int(n)) for n in a["n_valid"]],
                         jnp.int32)
    wav = jnp.asarray(a["wav"])
    ref = {"full": np.asarray(jax.jit(model.apply)(
        jvars, wav, num_valid_frames=frames))}
    mesh2 = JaxMesh(np.asarray(jax.devices()[:2]), ("model",))
    ref["pp"] = np.asarray(jax.jit(lambda v, w, f: jax_pp_apply(
        jcfg, v, w, mesh2, num_microbatches=2, num_valid_frames=f))(
            jvars, wav[:2], frames[:2]))
    ex = JaxExtractor(jvars, jcfg, **CHUNKING)
    ref["extract"] = [ex.extract_features(a["long"]), ex.extract(a["short"])]
    ref["specs"] = jax_tp_specs(variables)
    mp = {k: jnp.asarray(v) for k, v in a["moe"].items()}
    tok = jnp.asarray(a["tokens"])
    for s in (2, 4):
        emesh = JaxMesh(np.asarray(jax.devices()[:s]), ("expert",))
        ref[f"ep{s}"] = np.asarray(jax.jit(lambda p, t: jax_ep.moe_ffn_ep(
            p, t, emesh, "expert", capacity_factor=1.25))(mp, tok))
    return ref


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Every multi-rank case on one 4-rank group, the JAX references
    computed meanwhile; (inputs, per-rank results, JAX references)."""
    jcfg, cfg = jax_hubert.HubertConfig(**TINY), HubertConfig(**TINY)
    variables = random_jax_hubert(cfg, seed=4)
    rng = np.random.default_rng(8)
    inputs = {
        "config": cfg, "hubert": from_jax_hubert(variables, cfg),
        "wav": rng.standard_normal((4, 2000)).astype(np.float32),
        "n_valid": np.asarray([2000, 1500, 1210, 2000], np.int64),
        "chunking": CHUNKING,
        "long": rng.standard_normal((3300,)).astype(np.float32),
        "short": rng.standard_normal((700,)).astype(np.float32),
        "moe": {k: v.numpy() for k, v in
                ep.init_moe_params(24, 48, 4, seed=9).items()},
        "tokens": rng.standard_normal((16, 24)).astype(np.float32)}
    tmp = tmp_path_factory.mktemp("parallel")
    hub = tmp / "hubert"
    hub.mkdir()
    torch.save(inputs["hubert"], hub / "pytorch_model.bin")
    (hub / "config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    save_wav(str(tmp / "a.wav"), rng.standard_normal(16_000).astype(
        np.float32) * 0.1, 16_000)
    (tmp / "tp.json").write_text(json.dumps(
        {"mesh": {"model": 4, "hubert_parallel": "tp"}}))
    inputs.update(hubert_dir=str(hub), wav_path=str(tmp / "a.wav"),
                  feats_out=str(tmp / "feats.npy"),
                  tp_config=str(tmp / "tp.json"))
    results = {}

    def run():
        try:
            results["ranks"] = meshlib.launch(
                ranks.parallel_cases, 4, inputs,
                timeout_s=ranks.LAUNCH_TIMEOUT_S,
                dist_timeout_s=ranks.COLLECTIVE_TIMEOUT_S)
        except BaseException as e:  # raised in the test thread below
            results["error"] = e

    t = threading.Thread(target=run)
    t.start()
    ref = _jax_references(jcfg, variables, inputs)
    # launch bounds its own wait; this bounds the thread's, whatever held it
    t.join(ranks.LAUNCH_TIMEOUT_S + 60)
    assert not t.is_alive(), "the ranks' launch did not return"
    if "error" in results:
        raise results["error"]
    return inputs, results["ranks"], ref


def test_tp_specs_match_jax(cases):
    """q/k/v and intermediate_dense shard their output features (JAX: the
    heads / intermediate axis), out_proj and output_dense weights their
    input features; biases of the row-parallel layers, the front end and
    the norms stay whole, as in JAX's specs."""
    inputs, _, ref = cases
    specs = hubert_tp_specs(inputs["hubert"])
    jax_layer = ref["specs"]["params"]["encoder"]["layers_0"]
    expect = {"attention.q_proj.weight": (0, ("attention", "q_proj",
                                             "kernel")),
              "attention.q_proj.bias": (0, ("attention", "q_proj", "bias")),
              "attention.out_proj.weight": (1, ("attention", "out_proj",
                                               "kernel")),
              "attention.out_proj.bias": (None, ("attention", "out_proj",
                                                 "bias")),
              "feed_forward.intermediate_dense.weight": (
                  0, ("feed_forward", "intermediate_dense", "kernel")),
              "feed_forward.intermediate_dense.bias": (
                  0, ("feed_forward", "intermediate_dense", "bias")),
              "feed_forward.output_dense.weight": (
                  1, ("feed_forward", "output_dense", "kernel")),
              "layer_norm.weight": (None, ("layer_norm", "scale"))}
    for suffix, (dim, path) in expect.items():
        assert specs[f"encoder.layers.0.{suffix}"] == dim, suffix
        spec = jax_layer
        for p in path:
            spec = spec[p]
        assert (dim is None) == all(s is None for s in spec), suffix
    sharded = {k for k, v in specs.items() if v is not None}
    assert len(sharded) == 2 * 10  # 10 tensors a layer
    assert all(".layers." in k for k in sharded)


def test_tp_matches_unsharded_and_jax(cases):
    """Heads and MLP over 2 ranks, and over a (data=2, model=2) grid with
    the rows over data: the unsharded forward (masked) and JAX's."""
    _, out, ref = cases
    one = out[2]["one"]
    for o in out[:2]:
        _close(o["tp"], one)
        _close(o["tp"], ref["full"])
    for o in out:
        _close(o["tp_grid"], one)


@pytest.mark.parametrize("case", ["sequential", "masked", "m4"])
def test_pp_matches_the_sequential_encoder(cases, case):
    """GPipe over 2 stages against the one-device forward: unmasked (M=S),
    with bucket-pad masks rebuilt from the microbatch id, and with M=4 >
    S; every stage returns the whole output."""
    _, out, _ = cases
    one = out[2]["one"]
    ref = {"sequential": out[2]["one_unmasked"], "masked": one[:2],
           "m4": one}[case]
    for o in out[:2]:
        _close(o["pp"][case], ref, **PP_TOL)


def test_pp_matches_jax_and_composes_with_data(cases):
    """The masked 2-stage pipeline against JAX's hubert_pp_apply on 2
    devices; a (data=2, model=2) pipeline against the one-device
    forward."""
    _, out, ref = cases
    _close(out[0]["pp"]["masked"], ref["pp"])
    for o in out:
        _close(o["pp_grid"], out[2]["one"], **PP_TOL)


@pytest.mark.parametrize("mode", ["tp", "pp"])
def test_extractor_end_to_end(cases, mode):
    """HubertFeatureExtractor(mesh=, parallel=) on 2 ranks, the chunked
    path (3 chunks) and a single-row call, against the unsharded port and
    JAX's extractor."""
    _, out, ref = cases
    one = out[2]["one_extract"]
    tol = PP_TOL if mode == "pp" else {}
    for o in out[:2]:
        for got, want, jax_want in zip(o["extract"][mode], one,
                                       ref["extract"]):
            assert got.shape == want.shape == jax_want.shape
            _close(got, want, **tol)
            _close(got, jax_want)


def test_cli_featurize_over_four_ranks(cases, tmp_path):
    """``featurize`` with ``mesh.model`` 4 and ``hubert_parallel`` tp on
    the 4 ranks: the first writes the features of the unsharded
    extractor, at the repo's bar. Without that many ranks it exits with
    the launch it needs."""
    inputs, _, _ = cases
    want = HubertFeatureExtractor(inputs["hubert"], inputs["config"],
                                  device="cpu").extract_from_file(
                                      inputs["wav_path"])
    got = np.load(inputs["feats_out"])
    assert got.shape == want.shape == ((16_000 - 80) // 640, 2, 24)
    _close(got, want)
    with pytest.raises(SystemExit, match="nproc-per-node 4"):
        cli.main(["featurize", "--hubert", inputs["hubert_dir"],
                  "--audio", inputs["wav_path"], "--out",
                  str(tmp_path / "f.npy"), "--config", inputs["tp_config"],
                  "--device", "cpu"])


def test_parallel_refusals():
    """A pipelined batch that is not a multiple of the stages, layers or a
    batch that do not divide, and heads or an MLP that do not divide over
    the model axis."""
    cfg = HubertConfig(**TINY)
    two = SimpleNamespace(axis_size=lambda axis: 2, axis_index=lambda a: 0)
    three = SimpleNamespace(axis_size=lambda axis: 3, axis_index=lambda a: 0)
    with pytest.raises(ValueError, match="multiple of 2 stages"):
        HubertFeatureExtractor(None, cfg, device="cpu", mesh=two,
                               parallel="pp", pp_microbatches=3)
    with pytest.raises(ValueError, match="num_attention_heads"):
        shard_hubert(HubertModel(cfg), three)
    wide = HubertConfig(**{**TINY, "num_attention_heads": 6,
                           "intermediate_size": 51})
    with pytest.raises(ValueError, match="intermediate_size"):
        shard_hubert(HubertModel(wide), two)
    wav = torch.zeros((4, 400))
    with pytest.raises(ValueError, match="layers not divisible"):
        hubert_pp_apply(HubertModel(cfg), wav, three)
    with pytest.raises(ValueError, match="microbatches"):
        hubert_pp_apply(HubertModel(cfg), wav, two, num_microbatches=3)
    with pytest.raises(ValueError, match="not divisible by 2 stages"):
        hubert_pp_apply(HubertModel(cfg), wav[:1], two, num_microbatches=1)


def test_stack_encoder_layers_matches_jax():
    cfg = HubertConfig(**TINY)
    sd = from_jax_hubert(random_jax_hubert(cfg, seed=1), cfg)
    stacked = stack_encoder_layers(sd)
    w = stacked["attention.q_proj.weight"]
    assert w.shape == (2, 24, 24)
    torch.testing.assert_close(w[1], sd["encoder.layers.1.attention."
                                        "q_proj.weight"])
    assert len(stacked) == sum(k.startswith("encoder.layers.0.")
                               for k in sd)


# ------------------------------------------------------------------- EP

def _moe_pair(e=3, seed=0):
    params = ep.init_moe_params(16, 32, e, seed=seed)
    return params, {k: jnp.asarray(v.numpy()) for k, v in params.items()}


@pytest.mark.parametrize("cf,groups", [(0.5, 2), (1.25, 1)])
def test_moe_ffn_matches_jax(cf, groups):
    """Dense dispatch and combine with capacity drops (cf 0.5 overflows),
    fp32 and bf16 (the routing in fp32 both sides)."""
    params, jparams = _moe_pair()
    x = np.random.default_rng(1).standard_normal((2, 6, 16)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda p, v: jax_ep.moe_ffn(
        p, v, capacity_factor=cf, groups=groups))(jparams, jnp.asarray(x)))
    got = ep.moe_ffn(params, torch.from_numpy(x), capacity_factor=cf,
                     groups=groups)
    _close(got, want)
    if cf < 1:  # the capacity really dropped tokens
        assert (np.abs(want).sum(-1) == 0).any()
    bf = ep.moe_ffn(params, torch.from_numpy(x).bfloat16(),
                    capacity_factor=cf, groups=groups)
    assert bf.dtype == torch.bfloat16
    assert ((bf.float().abs().sum(-1) > 0).numpy()
            == (np.abs(want).sum(-1) > 0)).all()


@pytest.mark.parametrize("s", [2, 4])
def test_moe_ffn_ep_matches_jax(cases, s):
    """moe_ffn_ep over 2 and 4 ranks (two all_to_alls) against JAX's over
    2 and 4 devices, and against the one-device math with a group a rank;
    every rank returns the whole output."""
    inputs, out, ref = cases
    params = {k: torch.from_numpy(v) for k, v in inputs["moe"].items()}
    one = ep.moe_ffn(params, torch.from_numpy(inputs["tokens"]),
                     capacity_factor=1.25, groups=s)
    for o in out[:s]:
        _close(o[f"ep{s}"], ref[f"ep{s}"])
        _close(o[f"ep{s}"], one, **PP_TOL)


def test_one_expert_is_the_dense_ffn():
    """An upcycled one-expert MoE computes the dense FeedForward, and a
    one-expert MoEEncoderLayer the EncoderLayer, both norm modes."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 5, 16)).astype(np.float32))
    for stable in (True, False):
        cfg = HubertConfig(hidden_size=16, num_hidden_layers=2,
                           num_attention_heads=2, intermediate_size=32,
                           do_stable_layer_norm=stable)
        torch.manual_seed(3)
        dense = EncoderLayer(cfg).eval()
        moe = ep.MoEEncoderLayer(cfg, num_experts=1).eval()
        sd = {k: v for k, v in dense.state_dict().items()
              if not k.startswith("feed_forward.")}
        ffn_sd = {k[len("feed_forward."):]: v
                  for k, v in dense.state_dict().items()
                  if k.startswith("feed_forward.")}
        sd.update({f"moe.{k}": v for k, v in
                   ep.upcycle_ffn_to_moe(ffn_sd, 1).items()})
        moe.load_state_dict(sd, strict=True)
        with torch.no_grad():
            _close(moe(x), dense(x), rtol=1e-6, atol=1e-6)
            _close(moe.moe(x), dense.feed_forward(x), rtol=1e-6, atol=1e-6)


def test_upcycled_experts_scale_by_gate():
    """E identical experts: each token's output is its gate times the
    dense FFN (no drops at a high capacity), as JAX's upcycling test."""
    cfg = HubertConfig(hidden_size=16, intermediate_size=32)
    torch.manual_seed(4)
    ffn = FeedForward(cfg)
    params = ep.upcycle_ffn_to_moe(ffn.state_dict(), 4, seed=7)
    x = torch.randn(4, 16)
    gate = torch.softmax(x @ params["router"], -1).max(-1).values
    with torch.no_grad():
        _close(ep.moe_ffn(params, x, capacity_factor=4.0),
               gate[:, None] * ffn(x), rtol=1e-5, atol=1e-6)
    specs = ep.ep_param_specs()
    assert specs == {"router": None, "w_in": 0, "b_in": 0, "w_out": 0,
                     "b_out": 0}
    assert set(specs) == set(jax_ep.ep_param_specs())


def test_dryrun_multichip_2_on_the_cpu(cases):
    """dryrun.run_sections(2), as dryrun_multichip(2) runs it, inside the
    module's group: every section ran and held."""
    _, out, _ = cases
    r = out[0]["dryrun"]
    assert set(r["times"]) == {"init", "resident_dp_step", "zero1_step",
                               "sharded_serve", "pp_hubert", "tp_hubert",
                               "ep_moe"}
    assert np.isfinite(r["loss"]) and np.isfinite(r["zero1_loss"])
    assert out[1]["dryrun"]["loss"] == r["loss"]
    assert out[2]["dryrun"] == out[3]["dryrun"] == {}


def test_dryrun_runs_on_the_cards_unless_asked(monkeypatch):
    """Without CUDA the dry run and its command raise, before any rank
    starts, unless the caller asks for the CPU; NCCL needs a card a
    rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: dryrun.dryrun_multichip(2),
                lambda: dryrun.main(["2"]),
                lambda: dryrun.run_sections(2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 NCCL ranks need 2 cards"):
        dryrun.dryrun_multichip(2)
