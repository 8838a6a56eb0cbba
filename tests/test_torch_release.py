"""The port's release-weights persistence and prominence against the JAX package.

* the pure-Python msgpack reader on the committed flagship release
  (``artifacts/weights/uncond_demo_64``) against flax's ``msgpack_restore`` and
  the JAX ``load_release_weights``: the same tree, every leaf bit-equal after
  the f32 cast;
* the port's ``save_release_weights`` against the JAX one on the same tree:
  the same bytes, read back equal by JAX, bf16 rounded as ml_dtypes rounds;
* a Hypothesis round trip of the msgpack subset, byte-equal to flax's writer;
* ``params_to_jax`` against the JAX model's tree, and ``state_dict_from_release``;
* the trained weights' forward at flagship width, port against JAX, through
  the folded path on both sides (f32, at 16³; 64³ is marked ``slow``);
* ``prominence`` and the sampler's ``with_prominence`` against JAX.
"""

import dataclasses
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental.pallas import tpu as pltpu

from flowtrain_stochastic_interpolation_torch import config as port_config
from flowtrain_stochastic_interpolation_torch.inference import initial_noise, make_sampler
from flowtrain_stochastic_interpolation_torch.models import attention
from flowtrain_stochastic_interpolation_torch.models import persistence as port_persistence
from flowtrain_stochastic_interpolation_torch.models.attention import LinearAttention
from flowtrain_stochastic_interpolation_torch.ops import embedding as port_embedding
from flowtrain_stochastic_interpolation_torch.train.loop import build_model, init_model_variables
from flowtrain_stochastic_interpolation_torch.utils import msgpack_tree
from flowtrain_stochastic_interpolation_torch.utils.msgpack_tree import Bfloat16
from flowtrain_stochastic_interpolation_tpu import config as jax_config
from flowtrain_stochastic_interpolation_tpu import inference as jax_inference
from flowtrain_stochastic_interpolation_tpu.models import persistence as jax_persistence
from flowtrain_stochastic_interpolation_tpu.ops import embedding as jax_embedding
from flowtrain_stochastic_interpolation_tpu.train.loop import build_model as jax_build_model

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

RELEASE = Path(__file__).resolve().parents[1] / "artifacts" / "weights" / "uncond_demo_64"
LEAVES, VALUES = 299, 22_981_474


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)


@pytest.fixture(scope="module")
def release():
    """The committed release read three ways: the port's reader (raw and f32),
    flax's ``msgpack_restore``, the JAX ``load_release_weights``."""
    raw = (RELEASE / "weights.msgpack").read_bytes()
    return {
        "raw": raw,
        "port": msgpack_tree.unpackb(raw),
        "flax": serialization.msgpack_restore(raw),
        "port_f32": port_persistence.load_release_weights(str(RELEASE)),
        "jax_f32": jax_persistence.load_release_weights(str(RELEASE)),
    }


def test_reader_gives_flax_tree_bit_for_bit(release):
    port, flax_tree = release["port"], release["flax"]
    assert list(port) == list(flax_tree) == ["params", "ema_params", "constants"]
    assert port["ema_params"] == {} and port["constants"] == {}
    ours, theirs = list(_leaves(port["params"])), list(_leaves(flax_tree["params"]))
    assert [p for p, _ in ours] == [p for p, _ in theirs]  # the same keys in the same order
    assert len(ours) == LEAVES and sum(int(np.prod(v.shape)) for _, v in ours) == VALUES
    for (path, leaf), (_, ref) in zip(ours, theirs):
        assert isinstance(leaf, Bfloat16) and ref.dtype == ml_dtypes.bfloat16, path
        assert leaf.shape == ref.shape, path
        np.testing.assert_array_equal(leaf.bits, ref.view(np.uint16), err_msg=str(path))
        np.testing.assert_array_equal(_bits(leaf.to_float32()), _bits(ref.astype(np.float32)))


def test_load_release_weights_matches_jax(release):
    (tree, cfg, meta), (ref, ref_cfg, ref_meta) = release["port_f32"], release["jax_f32"]
    assert list(tree) == list(ref) and tree["ema_params"] == {} and tree["constants"] == {}
    ours, theirs = list(_leaves(tree)), list(_leaves(ref))
    assert [p for p, _ in ours] == [p for p, _ in theirs] and len(ours) == LEAVES
    for (path, leaf), (_, want) in zip(ours, theirs):
        assert leaf.dtype == np.float32 == want.dtype, path
        np.testing.assert_array_equal(_bits(leaf), _bits(want), err_msg=str(path))
    assert meta == ref_meta and meta["step"] == 3000
    assert cfg.to_dict() == ref_cfg.to_dict()
    assert cfg.model == port_config.unconditional_64().model


def test_reader_writes_the_release_back_byte_for_byte(release):
    assert msgpack_tree.packb(release["port"]) == release["raw"]


def _tiny_tree(seed=0):
    model = init_model_variables(port_config.tiny_test(), seed=seed, device="cpu")
    return port_persistence.params_to_jax(model.state_dict())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("with_ema", [False, True])
def test_writer_matches_jax_save_release_weights(tmp_path, dtype, with_ema):
    params = _tiny_tree(0)
    ema = _tiny_tree(1) if with_ema else None
    kwargs = dict(params=params, ema_params=ema, config_json=port_config.tiny_test().to_json(),
                  step=7, dtype=dtype, note="tiny")
    port_persistence.save_release_weights(str(tmp_path / "port"), **kwargs)
    jax_persistence.save_release_weights(str(tmp_path / "jax"), **kwargs)
    for name in ("weights.msgpack", "meta.json", "config.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    tree, _, meta = jax_persistence.load_release_weights(str(tmp_path / "port"), cast_to=None)
    assert meta == {"step": 7, "dtype": dtype, "note": "tiny"}
    for key, src in (("params", params), ("ema_params", ema)):
        if src is None:
            assert tree[key] == {}
            continue
        got = dict(_leaves(tree[key]))
        assert set(got) == {p for p, _ in _leaves(src)}
        for path, value in _leaves(src):
            want = value.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else value
            assert got[path].dtype == want.dtype
            np.testing.assert_array_equal(got[path].view(np.uint8), want.view(np.uint8))


def test_bf16_rounding_matches_ml_dtypes():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        (rng.standard_normal(100_000) * 10.0 ** rng.integers(-40, 38, 100_000)).astype(np.float32),
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 3.4028235e38, 1e-45], np.float32),
        np.array([0x3F808000, 0x3F818000, 0x3F80FFFF, 0x7F7FFFFF, 0x7F800001, 0xFFBFFFFF],
                 np.uint32).view(np.float32),  # ties to even, carries, signalling NaNs
    ])
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(msgpack_tree.to_bfloat16(x).bits, want)


_DTYPES = ("float32", "bfloat16", "int32", "int8", "uint8", "int64", "bool")


@st.composite
def _arrays(draw):
    dtype = draw(st.sampled_from(_DTYPES))
    shape = tuple(draw(st.lists(st.integers(0, 3), min_size=0, max_size=5)))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    values = rng.standard_normal(shape) * 100.0
    if dtype == "bool":
        return values > 0
    if dtype == "bfloat16":
        return msgpack_tree.to_bfloat16(values)
    return values.astype(dtype)


_trees = st.recursive(
    _arrays(),
    lambda children: st.dictionaries(st.text(min_size=1, max_size=20), children, max_size=5),
    max_leaves=12,
)


def _to_flax(tree):
    """The same tree with ``Bfloat16`` leaves as ml_dtypes arrays (flax's form)."""
    if isinstance(tree, dict):
        return {k: _to_flax(v) for k, v in tree.items()}
    if isinstance(tree, Bfloat16):
        return tree.bits.view(ml_dtypes.bfloat16)
    return tree


def _from_flax(tree):
    if isinstance(tree, dict):
        return {k: _from_flax(v) for k, v in tree.items()}
    if tree.dtype == ml_dtypes.bfloat16:
        return Bfloat16(tree.view(np.uint16))
    return tree


def _assert_same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for key in want:
            _assert_same(got[key], want[key])
    elif isinstance(want, Bfloat16):
        assert isinstance(got, Bfloat16) and got.shape == want.shape
        np.testing.assert_array_equal(got.bits, want.bits)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@settings(max_examples=60, deadline=None)
@given(tree=st.dictionaries(st.text(min_size=1, max_size=20), _trees, max_size=4))
def test_msgpack_round_trip_and_flax_bytes(tree):
    data = msgpack_tree.packb(tree)
    _assert_same(msgpack_tree.unpackb(data), tree)
    assert data == serialization.to_bytes(_to_flax(tree))  # the JAX package's save_model
    _assert_same(msgpack_tree.unpackb(serialization.to_bytes(_to_flax(tree))), tree)
    _assert_same(_from_flax(serialization.msgpack_restore(data)), tree)


@pytest.mark.parametrize("preset", ["tiny", "flagship"])
def test_params_to_jax_is_the_jax_tree_and_reverses_params_from_jax(preset):
    port_cfg = port_config.tiny_test() if preset == "tiny" else port_config.unconditional_64()
    jax_cfg = jax_config.ExperimentConfig.from_dict(port_cfg.to_dict())
    model = init_model_variables(port_cfg, device="cpu")
    tree = port_persistence.params_to_jax(model.state_dict())
    e = port_cfg.data.embedding_dim
    shapes = jax.eval_shape(jax_build_model(jax_cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 8, 8, e)) if preset == "tiny"
                            else jnp.zeros((1, 16, 16, 16, e)), jnp.zeros((1,)))["params"]
    want = {p: s.shape for p, s in _leaves(jax.tree_util.tree_map(lambda a: a, dict(shapes)))}
    assert {p: v.shape for p, v in _leaves(tree)} == want
    back = port_persistence.params_from_jax(tree, model)
    for key, value in model.state_dict().items():
        assert torch.equal(back[key], value), key


def test_state_dict_from_release_picks_ema_only_when_present():
    model = init_model_variables(port_config.tiny_test(), device="cpu")
    params = port_persistence.params_to_jax(model.state_dict())
    other = port_persistence.params_to_jax(
        init_model_variables(port_config.tiny_test(), seed=5, device="cpu").state_dict())
    for ema, use_ema, want in ((other, True, other), (other, False, params), ({}, True, params)):
        tree = {"params": params, "ema_params": ema, "constants": {}}
        got = port_persistence.state_dict_from_release(tree, model, use_ema=use_ema)
        ref = port_persistence.params_from_jax(want)
        assert set(got) == set(ref) and all(torch.equal(got[k], ref[k]) for k in ref)
    # constants travel beside the params (JAX keeps RandomFourier's frozen freqs
    # there); the tiny UNet has no such leaf, so the model check names it
    tree = {"params": params, "ema_params": {},
            "constants": {"extra": {"freqs": np.ones(8, np.float32)}}}
    got = port_persistence.state_dict_from_release(tree)
    assert torch.equal(got["extra.freqs"], torch.ones(8)) and len(got) == len(ref) + 1
    with pytest.raises(KeyError, match="extra.freqs"):
        port_persistence.state_dict_from_release(tree, model)


def test_save_and_load_model_check_the_template(tmp_path):
    tree = {"params": {"a": np.arange(3, dtype=np.float32)}, "step": np.int32(4)}
    path = str(tmp_path / "m.msgpack")
    port_persistence.save_model(tree, path)
    assert (tmp_path / "m.msgpack").read_bytes() == serialization.to_bytes(tree)
    got = port_persistence.load_model(tree, path)
    np.testing.assert_array_equal(got["params"]["a"], tree["params"]["a"])
    assert got["step"] == 4
    with pytest.raises(ValueError, match="keys"):
        port_persistence.load_model({"params": {"b": 0}, "step": 0}, path)
    assert not port_persistence.is_release_weights_dir(str(tmp_path))
    assert port_persistence.is_release_weights_dir(str(RELEASE))


def _trained_pair(release, monkeypatch, side):
    """The trained weights' f32 forward at ``side``³ b1, t = 0.5, through the
    folded path on both sides: ``(port, jax)`` outputs."""
    port_cfg = port_config.unconditional_64()
    port_cfg = dataclasses.replace(port_cfg, model=dataclasses.replace(
        port_cfg.model, dtype="float32", dropout=0.0))
    jax_cfg = jax_config.ExperimentConfig.from_dict(port_cfg.to_dict())
    folded = []
    monkeypatch.setattr(LinearAttention, "takes_folded", lambda self, qkv: (
        self.fused_folded and qkv.shape[1] >= attention._FOLDED_LINEAR_MIN_TOKENS
        and self.heads * self.dim_head % 128 == 0))  # the rule on the card, without is_cuda
    attend = LinearAttention.attend_folded
    monkeypatch.setattr(LinearAttention, "attend_folded",
                        lambda self, qkv: folded.append(qkv.shape[1]) or attend(self, qkv))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")  # the JAX module's folded rule
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, side, side, side, 18)).astype(np.float32)
    t = np.full((1,), 0.5, np.float32)
    tree, _, _ = release["port_f32"]
    port = build_model(port_cfg, device="cpu").eval()
    port.load_state_dict(port_persistence.state_dict_from_release(tree, port))
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    jtree = release["jax_f32"][0]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax.jit(jax_build_model(jax_cfg).apply)(
            {"params": jtree["params"]}, jnp.asarray(x), jnp.asarray(t)))
    return out, ref, folded


def test_trained_flagship_forward_matches_jax_at_16_cubed(release, monkeypatch):
    """The committed release at flagship width, 16³ x b1: the 4096-token linear
    attentions (down 0 and up 4) take the folded path on both sides, as on the
    card, and round p and v to bf16 there; held at the flagship-width 2e-3."""
    out, ref, folded = _trained_pair(release, monkeypatch, 16)
    assert folded == [4096, 4096]
    assert out.shape == ref.shape == (1, 16, 16, 16, 18) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-3)


@pytest.mark.slow
def test_trained_flagship_forward_matches_jax_at_64_cubed(release, monkeypatch):
    out, ref, folded = _trained_pair(release, monkeypatch, 64)
    assert folded == [262144, 32768, 4096, 4096, 32768, 262144]
    assert out.shape == ref.shape == (1, 64, 64, 64, 18) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-3)


@pytest.mark.parametrize("case", ["random", "ties", "one_hot"])
def test_prominence_matches_jax(case):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((4, 5, 6, 15)).astype(np.float32)
    if case == "ties":  # the two largest equal (margin 0), and all equal
        logits[..., 3] = logits.max(-1) + 1.0
        logits[..., 7] = logits[..., 3]
        logits[0, 0] = 0.25
    elif case == "one_hot":
        logits = np.where(np.arange(15) == 4, 30.0, -30.0).astype(np.float32) * np.ones_like(logits)
    got = port_embedding.prominence(torch.from_numpy(logits)).numpy()
    want = np.asarray(jax_embedding.prominence(jnp.asarray(logits)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got >= 0).all() and (got <= 1).all()
    if case == "ties":
        assert (got == 0).all()
    # the JAX decode's return_logits is the port's decode_logits
    x, table = logits[..., :4], np.eye(4, dtype=np.float32)
    got_logits = port_embedding.decode_logits(torch.from_numpy(x), torch.from_numpy(table))
    want_logits = jax_embedding.decode(jnp.asarray(x), jnp.asarray(table), return_logits=True)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=0, atol=1e-6)
    assert torch.equal(port_embedding.decode(torch.from_numpy(x), torch.from_numpy(table)),
                       torch.argmax(got_logits, dim=-1))


def test_sampler_with_prominence_matches_jax():
    """``with_prominence`` on the tiny model, the same weights and x0 on both sides."""
    port_cfg = port_config.tiny_test()
    jax_cfg = jax_config.ExperimentConfig.from_dict(port_cfg.to_dict())
    model = init_model_variables(port_cfg, device="cpu").eval()
    params = port_persistence.params_to_jax(model.state_dict())
    table = port_embedding.simplex_embedding(15, 15)
    x0 = initial_noise(torch.Generator().manual_seed(1), 2, (8, 8, 8), 15, torch.float32,
                       torch.device("cpu"))
    kw = dict(t0=0.001, tf=1.0, n_frames=3, substeps=1, method="rk4", with_prominence=True)
    out = make_sampler(model, torch.from_numpy(table), **kw)(x0)
    ref = jax_inference.make_sampler(jax_build_model(jax_cfg), {"params": params},
                                     jnp.asarray(table), **kw)(jnp.asarray(x0.numpy()))
    got, want = out["prominence"].numpy(), np.asarray(ref["prominence"])
    assert got.shape == want.shape == (2, 8, 8, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (out["decoded"].numpy() == np.asarray(ref["decoded"])).mean() > 0.999
