"""The port's msgpack reader against flax, on the JAX package's own files.

``relgat-model.msgpack`` and ``train-state.msgpack`` written by the JAX
package's ``save_pretrained`` and ``save_train_state`` (fp32 and bf16
parameters; Adam and AdamW, each with and without clipping and decay) are
read by ``relgat_projector_tpu_torch.utils.msgpack`` and by
``flax.serialization.msgpack_restore``: the same tree, every leaf of the
same type and bit for bit. Chunked leaves (flax's ``MAX_CHUNK_SIZE`` made
small), every msgpack header width and malformed input are covered too.
"""

import dataclasses
import struct

import jax
import jax.numpy as jnp
import msgpack as msgpack_ref
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from relgat_projector_tpu.config import ModelConfig as JaxModelConfig
from relgat_projector_tpu.config import TrainConfig as JaxTrainConfig
from relgat_projector_tpu.models.model import init_model as jax_init_model
from relgat_projector_tpu.models.model import save_pretrained as jax_save
from relgat_projector_tpu.train import checkpoint as jax_ckpt
from relgat_projector_tpu.train import state as jax_state
from relgat_projector_tpu_torch.config import ModelConfig
from relgat_projector_tpu_torch.models.model import init_model
from relgat_projector_tpu_torch.utils import msgpack as mp
from relgat_projector_tpu_torch.utils.tree import tree_leaves

MODEL = dict(in_dim=12, num_rel=3, gat_out_dim=4, gat_heads=2,
             gat_num_layers=2, projection_layers=2)
OPTIMIZERS = {
    "adam": dict(optimizer="adam"),
    "adam_clip_wd": dict(optimizer="adam", grad_clip_norm=1.0,
                         weight_decay=1e-2),
    "adamw": dict(optimizer="adamw"),
    "adamw_clip_wd": dict(optimizer="adamw", grad_clip_norm=1.0,
                          weight_decay=1e-2),
}


def assert_same(got, want, path="root"):
    """``got`` (the port's reader) is ``want`` (flax's), leaf for leaf."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}/{k}")
        return
    if isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}/{i}")
        return
    if isinstance(want, (np.ndarray, np.generic)):
        want = np.asarray(want)
        assert isinstance(got, torch.Tensor), path
        assert tuple(got.shape) == want.shape, path
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(got.view(torch.uint16).numpy(),
                                          want.view(np.uint16), err_msg=path)
        else:
            assert got.numpy().dtype == want.dtype, path
            np.testing.assert_array_equal(
                got.numpy().reshape(-1).view(np.uint8),
                want.reshape(-1).view(np.uint8), err_msg=path)
        return
    assert type(got) is type(want) and got == want, path


def _jax_params(param_dtype):
    cfg = JaxModelConfig(**MODEL, param_dtype=param_dtype)
    return cfg, jax_init_model(jax.random.PRNGKey(0), cfg)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_model_file_matches_flax(tmp_path, param_dtype):
    cfg, params = _jax_params(param_dtype)
    jax_save(str(tmp_path), params, cfg)
    data = (tmp_path / "relgat-model.msgpack").read_bytes()
    assert_same(mp.msgpack_restore(data), serialization.msgpack_restore(data))
    # Rebuilt on the port's template: the lists come back as lists.
    template = init_model(ModelConfig(**MODEL, param_dtype=param_dtype),
                          device="cpu")
    got = mp.from_bytes(template, data)
    want = jax.tree_util.tree_leaves(
        serialization.from_bytes(jax.device_get(params), data))
    assert len(tree_leaves(got)) == len(want)
    for g, w in zip(tree_leaves(got), want):
        assert g.dtype == (torch.bfloat16 if param_dtype == "bfloat16"
                           else torch.float32)
        assert_same(g, np.asarray(w))


@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_train_state_file_matches_flax(tmp_path, opt_name, param_dtype):
    _, params = _jax_params(param_dtype)
    tc = JaxTrainConfig(**OPTIMIZERS[opt_name])
    opt = jax_state.make_optimizer(tc, optax.constant_schedule(1e-3))
    state = jax_state.create_train_state(params, opt, jax.random.PRNGKey(3))
    # Moments and counts that are not zero, so their bits are worth
    # comparing.
    state = dataclasses.replace(state, opt_state=jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(0.1, a.dtype)
        if jnp.issubdtype(a.dtype, jnp.floating) else a + 7,
        state.opt_state), step=jnp.asarray(5, jnp.int32))
    path = tmp_path / "train-state.msgpack"
    jax_ckpt.save_train_state(str(path), state)
    data = path.read_bytes()
    assert_same(mp.msgpack_restore(data), serialization.msgpack_restore(data))


def test_chunked_leaf_matches_flax(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(0)
    tree = {
        "big": rng.standard_normal((7, 5)).astype(np.float32),   # 4 chunks
        "bf16": np.asarray(jnp.asarray(rng.standard_normal(40),
                                       jnp.bfloat16)),           # 2 chunks
        "nested": {"small": np.arange(3, dtype=np.int32)},
    }
    data = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    assert_same(mp.msgpack_restore(data), serialization.msgpack_restore(data))


def _packed(obj):
    return msgpack_ref.packb(obj, use_bin_type=True)


@pytest.mark.parametrize("obj", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31 - 1, -2**63,
    1.5, -0.0, True, False, None, "", "a" * 31, "b" * 32, "c" * 256,
    "ż" * 40000, b"", b"x" * 255, b"y" * 256, b"z" * 70000,
    list(range(15)), list(range(16)), list(range(70000)),
    {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {str(i): i for i in range(70000)},
], ids=lambda o: type(o).__name__ + str(len(o) if hasattr(o, "__len__")
                                        else o)[:12])
def test_every_header_width(obj):
    assert mp.unpackb(_packed(obj)) == obj


def test_float32():
    assert mp.unpackb(msgpack_ref.packb(1.25, use_single_float=True)) == 1.25


def _ndarray_payload(k):
    """flax's ndarray payload for ``k`` zero bytes of uint8: 11 + k bytes."""
    return serialization._ndarray_to_bytes(np.zeros(k, np.uint8))


@pytest.mark.parametrize("fmt", ["fixext16", "ext8", "ext16", "ext32"])
def test_every_ext_format(fmt):
    k = {"fixext16": 5, "ext8": 100, "ext16": 1_000, "ext32": 70_000}[fmt]
    payload = _ndarray_payload(k)
    n = len(payload)
    head = {"fixext16": lambda: b"\xd8",
            "ext8": lambda: b"\xc7" + struct.pack(">B", n),
            "ext16": lambda: b"\xc8" + struct.pack(">H", n),
            "ext32": lambda: b"\xc9" + struct.pack(">I", n)}[fmt]()
    data = head + b"\x01" + payload
    assert data == msgpack_ref.packb(msgpack_ref.ExtType(1, payload))
    assert_same(mp.unpackb(data), np.zeros(k, np.uint8))
    # The same payload as an npscalar-typed ext (type 3) reads the same.
    assert_same(mp.unpackb(head + b"\x03" + payload), np.zeros(k, np.uint8))


@pytest.mark.parametrize("n,code", [(1, 0xD4), (2, 0xD5), (4, 0xD6),
                                    (8, 0xD7), (16, 0xD8)])
def test_fixext_widths(n, code):
    """No ndarray fits in 1-8 bytes: each fixext is read to its width, and
    its payload is then refused, naming the ext's offset."""
    data = b"\x91" + bytes([code, 1]) + b"\xc0" * n
    with pytest.raises(ValueError, match="bad ndarray .* at byte 1"):
        mp.unpackb(data)


@pytest.mark.parametrize("value", [
    np.float32(2.5), np.int32(-7), np.uint32(2**32 - 1), np.int64(2**40),
    np.bool_(True), np.float64(1e-300),
    np.asarray(jnp.asarray(1.1, jnp.bfloat16))[()],
])
def test_npscalar_matches_flax(value):
    data = serialization.msgpack_serialize({"x": value})
    assert_same(mp.msgpack_restore(data), serialization.msgpack_restore(data))


@pytest.mark.parametrize("arr", [
    np.zeros((0,), np.float32), np.zeros((3, 0, 2), np.int32),
    np.array(5, np.int32), np.array(-1.5, np.float64),
    np.arange(24, dtype=np.float16).reshape(2, 3, 4),
    np.array([[True, False]]), np.arange(6, dtype=np.uint64),
    np.asarray(jnp.asarray(np.linspace(-3, 3, 9), jnp.bfloat16)),
    np.asarray(jnp.zeros((0, 2), jnp.bfloat16)),
], ids=lambda a: f"{a.dtype.name}{a.shape}")
def test_zero_size_zero_d_and_every_dtype(arr):
    data = serialization.msgpack_serialize({"a": arr, "b": [arr]})
    assert_same(mp.msgpack_restore(data), serialization.msgpack_restore(data))


@pytest.mark.parametrize("data,where", [
    (b"", "at byte 0"),
    (b"\xc1", "reserved format byte 0xc1 at byte 0"),
    (b"\x92\x01", "at byte 2"),                       # array cut short
    (b"\x01\x02", "1 trailing bytes at byte 1"),
    (b"\xdb\x00\x00\x00\x05ab", "at byte 5"),         # str32 cut short
    (b"\x81\xa1k\xd4\x02\x00", "ext type 2"),         # native complex
    (b"\xd4\xff\x00", "ext type -1"),                 # timestamp
    (b"\xa2\xff\xfe", "not UTF-8 at byte 0"),
])
def test_malformed_input_raises_with_offset(data, where):
    with pytest.raises(ValueError, match=where):
        mp.unpackb(data)


def test_bad_ndarray_payloads_raise():
    def ext(tpl):
        return msgpack_ref.packb(msgpack_ref.ExtType(
            1, msgpack_ref.packb(tpl, use_bin_type=True)))

    cases = [
        (((2,), "float32", b"\x00" * 4), "4 bytes for shape"),
        (((2,), "no_such_type", b"\x00" * 8), "dtype"),
        (((2,), "object", b"\x00" * 16), "dtype"),
        (((-1,), "float32", b""), "shape"),
        ((2, "float32"), "expected"),
    ]
    for tpl, what in cases:
        with pytest.raises(ValueError, match=what):
            mp.unpackb(ext(tpl))


def test_template_mismatch_raises():
    template = {"a": [torch.zeros(1), torch.zeros(1)], "b": torch.zeros(1)}
    with pytest.raises(ValueError, match="a list of 2 items"):
        mp.restore_like(template, {"a": {"0": 1}, "b": 2})
    with pytest.raises(ValueError, match="keys"):
        mp.restore_like(template, {"a": {"0": 1, "1": 2}})
