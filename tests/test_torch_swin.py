"""The port's Swin backbone (dhd_tpu_torch.nn.swin) and its two ops, the
one-pass LayerNorm (kernel B5's plain version) and window attention
(kernel B4's plain version), against the JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode and its XLA / flax
paths; the port's wrappers take their plain versions on CPU tensors.
Modules carry weights converted by the port's rule table
(``dhd_tpu_torch.io.convert``), with the LayerNorm affines and the bias
tables made random so that they matter.  B5's two Swin block launches are
held here by their row maps (the kernel's arithmetic against the chain's
permutations), their plain versions against the block's chain, and the
rule for which calls take them."""
import contextlib
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhd_tpu.nn.swin import FusedLayerNorm as JFusedLayerNorm
from dhd_tpu.nn.swin import PatchMerging as JPatchMerging
from dhd_tpu.nn.swin import SwinBlock as JSwinBlock
from dhd_tpu.nn.swin import SwinTransformer as JSwinTransformer
from dhd_tpu.nn.swin import _relative_position_index as j_rel_index
from dhd_tpu.nn.swin import _shift_attn_mask as j_shift_mask
from dhd_tpu.nn.swin import _window_perms as j_window_perms
from dhd_tpu.nn.swin import window_partition as j_window_partition
from dhd_tpu.ops.layer_norm import fused_layer_norm
from dhd_tpu.ops.window_attention import (window_attention_pallas,
                                          window_attention_pallas_v2)
from dhd_tpu_torch.io import convert as C
from dhd_tpu_torch.nn import swin as S
from dhd_tpu_torch.config import get_config
from dhd_tpu_torch.ops import (fused_layer_norm_cuda, layer_norm_plain,
                               swin_residual_norm_cuda, swin_window_norm_cuda,
                               window_attention_cuda, window_attention_plain)
from dhd_tpu_torch.ops import layer_norm as L
from dhd_tpu_torch.ops.window_attention import attention_scale
from dhd_tpu_torch.profiling import kernel_launches
from chip_variants import swin_stage_shapes
from torch_cases import (bits_apart, residual_norm_chain, tiny_dhd_l,
                         window_norm_chain)


def _rel_to_peak(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(1e-3, float(np.abs(b).max()))


def _bf16_ulps(a, b):
    """Largest distance in bf16 ulps between two arrays of bf16 values."""
    def ordered(x):
        bits = (np.asarray(x, np.float32).view(np.uint32) >> 16).astype(
            np.int64)
        return np.where(bits >= 0x8000, -(bits & 0x7FFF), bits)
    return int(np.abs(ordered(a) - ordered(b)).max())


def _f32(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(
        t, np.float32)


# ---------------------------------------------------------------- LayerNorm

@pytest.mark.parametrize("ref", ["pallas_interpret", "flax"])
@pytest.mark.parametrize("shape,dtype", [
    ((6, 176, 512), "bfloat16"),     # DHD-L stage-2-like (rows, C)
    ((2, 77, 128), "bfloat16"),
    ((3, 40, 256), "float32"),
])
def test_layer_norm_plain_matches_jax(shape, dtype, ref):
    """fp32 within 1e-5; bf16 within one bf16 ulp per element (the fp32
    row sums run in another order)."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, shape).astype(np.float32)
    c = shape[-1]
    scale = rng.normal(1, 0.2, (c,)).astype(np.float32)
    bias = rng.normal(0, 0.5, (c,)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    if ref == "flax":
        mod = JFusedLayerNorm(use_kernel=False, dtype=getattr(jnp, dtype))
        want = mod.apply({"params": {"scale": scale, "bias": bias}}, jx)
    else:
        want = fused_layer_norm(jx, jnp.asarray(scale), jnp.asarray(bias),
                                interpret=True)
    tx = torch.from_numpy(np.array(jx, np.float32)).to(
        getattr(torch, dtype))
    got = layer_norm_plain(tx, torch.from_numpy(scale),
                           torch.from_numpy(bias))
    assert got.dtype == tx.dtype and tuple(got.shape) == shape
    # the wrapper takes the plain version on the CPU and counts no launch
    before = kernel_launches()["fused_layer_norm_cuda"]
    assert torch.equal(fused_layer_norm_cuda(tx, torch.from_numpy(scale),
                                             torch.from_numpy(bias)), got)
    assert kernel_launches()["fused_layer_norm_cuda"] == before
    if dtype == "bfloat16":
        assert _bf16_ulps(_f32(got), _f32(want)) <= 1
    else:
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5,
                                   atol=1e-5)


def test_layer_norm_eps_is_1e6():
    """eps 1e-6 under the rsqrt (the torch oracle's nn.LayerNorm default of
    1e-5 is wrong here): a row of variance 2.5e-7."""
    y = torch.tensor([[0.0, 1e-3]])
    got = layer_norm_plain(y, torch.ones(2), torch.zeros(2))
    want = torch.tensor([[-1.0, 1.0]]) * 5e-4 / (2.5e-7 + 1e-6) ** 0.5
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------- window attention

def _xla_window_attention(qkv, bias, mask, heads):
    """The JAX package's XLA composition (nn/swin.py:193-206), in qkv's
    dtype (tools/check_attn_parity.py:_xla_path)."""
    w, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads
    qr = qkv.reshape(w, n, 3, heads, hd)
    q, k, v = qr[:, :, 0], qr[:, :, 1], qr[:, :, 2]
    q = q * (hd ** -0.5)
    attn = jnp.einsum("bnhd,bmhd->bhnm", q, k) + bias[None].astype(q.dtype)
    nw = mask.shape[0]
    attn = attn.reshape(w // nw, nw, heads, n, n) \
        + mask[None, :, None].astype(attn.dtype)
    attn = attn.reshape(w, heads, n, n)
    p = jax.nn.softmax(attn.astype(jnp.float32), axis=-1).astype(qkv.dtype)
    return jnp.einsum("bhnm,bmhd->bnhd", p, v).reshape(w, n, c)


def _attn_inputs(rng, n_img, heads, c, w=8, n=16):
    qkv = rng.normal(0, 1, (w, n, 3 * c)).astype(np.float32)
    bias = rng.normal(0, 1, (heads, n, n)).astype(np.float32)
    if n_img == 1:
        mask = np.zeros((1, n, n), np.float32)
    else:
        mask = (rng.integers(0, 2, (n_img, n, n)) * -100.0).astype(np.float32)
    return qkv, bias, mask


@pytest.mark.parametrize("kernel,n_img,heads,c", [
    ("v1", 1, 2, 32), ("v1", 4, 4, 64),                      # test_swin:154
    ("v2", 1, 8, 128), ("v2", 4, 16, 256), ("v2", 2, 8, 64),  # test_swin:191
])
def test_window_attention_plain_matches_jax(kernel, n_img, heads, c):
    """fp32: the port's plain version against JAX's Pallas kernel (v1 or
    v2, interpret mode) and its XLA composition, within 1e-5."""
    qkv, bias, mask = _attn_inputs(np.random.default_rng(0), n_img, heads, c)
    fn = window_attention_pallas if kernel == "v1" else \
        window_attention_pallas_v2
    j_args = [jnp.asarray(a) for a in (qkv, bias, mask)]
    want_k = fn(*j_args, heads=heads, interpret=True)
    want_x = _xla_window_attention(*j_args, heads)
    t_args = [torch.from_numpy(a) for a in (qkv, bias, mask)]
    got = window_attention_plain(*t_args, heads)
    before = kernel_launches()["window_attention_cuda"]
    assert torch.equal(window_attention_cuda(*t_args, heads), got)
    assert kernel_launches()["window_attention_cuda"] == before
    for want in (want_k, want_x):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    if n_img == 1:       # a None mask is the zero mask
        torch.testing.assert_close(
            window_attention_plain(t_args[0], t_args[1], None, heads), got,
            rtol=0, atol=0)


def test_window_attention_bf16_rounds_the_scale_first():
    """In bf16 the scale is rounded to bf16 before it multiplies q, as JAX
    rounds its weak-typed scalar: 0.1767578125 for hd=32.  The plain version
    then follows JAX's XLA composition op for op in bf16."""
    assert attention_scale(32, torch.bfloat16) == 0.1767578125
    assert attention_scale(16, torch.bfloat16) == 0.25
    assert attention_scale(32, torch.float32) == float(np.float32(32 ** -0.5))
    rng = np.random.default_rng(3)
    qkv, bias, mask = _attn_inputs(rng, 4, 2, 64, w=8, n=36)
    j_args = [jnp.asarray(a, jnp.bfloat16) for a in (qkv, bias, mask)]
    want = np.asarray(_xla_window_attention(*j_args, 2), np.float32)
    t_args = [torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
              for a in j_args]
    got = window_attention_plain(*t_args, 2).float().numpy()
    peak_ulp = float(np.spacing(np.float32(np.abs(want).max()))) * 2 ** 16
    assert np.abs(got - want).max() <= peak_ulp
    assert np.mean(got == want) > 0.99


@pytest.mark.parametrize("wrapper", ["attention", "layer_norm",
                                     "window_norm", "residual_norm"])
def test_wrappers_raise_off_the_cpu_and_cuda(wrapper):
    """A wrapper takes its plain version only on a CPU tensor: on any
    other device that is not CUDA it raises before it launches."""
    meta = torch.device("meta")
    affine = (torch.empty(64, device=meta), torch.empty(64, device=meta))
    x = torch.empty((2, 63, 64), device=meta)
    if wrapper == "attention":
        fn, args = window_attention_cuda, (
            torch.empty((2, 16, 96), device=meta),
            torch.empty((2, 16, 16), device=meta), None, 2)
    elif wrapper == "layer_norm":
        fn, args = fused_layer_norm_cuda, (
            torch.empty((4, 64), device=meta), *affine)
    elif wrapper == "window_norm":
        fn, args = swin_window_norm_cuda, (x, *affine, 1e-6, (7, 9), 4, 2)
    else:
        fn, args = swin_residual_norm_cuda, (
            x, torch.empty((160, 64), device=meta), *affine, 1e-6, (7, 9),
            4, 2)
    before = kernel_launches()[fn.__name__]
    with pytest.raises(ValueError, match="unsupported device meta"):
        fn(*args)
    assert kernel_launches()[fn.__name__] == before


# ----------------------------------------------- permutations, index, mask

@pytest.mark.parametrize("h,w,ws,shift", [
    (16, 44, 12, 6), (16, 44, 12, 0), (7, 9, 4, 2), (8, 8, 4, 0)])
def test_window_tables_equal_jax(h, w, ws, shift):
    hp, wp = h + (ws - h % ws) % ws, w + (ws - w % ws) % ws
    for got, want in zip(S._window_perms(hp, wp, h, w, ws, shift),
                         j_window_perms(hp, wp, h, w, ws, shift)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(S._relative_position_index(ws),
                                  j_rel_index(ws))
    if shift:
        np.testing.assert_array_equal(S._shift_attn_mask(hp, wp, ws, shift),
                                      j_shift_mask(hp, wp, ws, shift))
    x = np.random.default_rng(1).normal(0, 1, (2, hp, wp, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        S.window_partition(torch.from_numpy(x), ws).numpy(),
        np.asarray(j_window_partition(jnp.asarray(x), ws)))
    np.testing.assert_array_equal(
        S.window_reverse(S.window_partition(torch.from_numpy(x), ws), ws,
                         hp, wp).numpy(), x)


# ------------------------------------- B5's Swin block launches: row maps

def _preset_windows():
    """Each (h, w, ws, shift) a Swin of the presets reaches: DHD-L's four
    stages and the tiny DHD-L's, unshifted and shifted."""
    out = set()
    for cfg in (get_config("dhd_l"), tiny_dhd_l(get_config)):
        for h, w, *_ in swin_stage_shapes(cfg):
            ws = cfg.swin_window
            out |= {(h, w, ws, 0), (h, w, ws, ws // 2)}
    return sorted(out)


ODD_WINDOWS = [(7, 9, 4, 2), (9, 7, 5, 2), (1, 1, 4, 2), (5, 3, 4, 0),
               (13, 5, 7, 3), (12, 12, 12, 6), (25, 37, 6, 3), (3, 4, 1, 0)]


@pytest.mark.parametrize("h,w,ws,shift", _preset_windows() + ODD_WINDOWS)
def test_window_row_maps_equal_the_perms(h, w, ws, shift):
    """The row maps of B5's block launches (``ops/layer_norm.py:
    window_rows``, ``residual_rows``: the kernel's arithmetic, divisions
    by a multiply and a shift) against ``_window_perms`` (the chain's
    gathers), over three images: each window row the token the padded,
    shifted partition puts there (-1 on padding), each token the window
    row the reverse brings back."""
    hp, wp = L.padded(h, w, ws)
    fwd, inv = S._window_perms(hp, wp, h, w, ws, shift)
    si, sj = np.divmod(fwd.astype(np.int64), wp)
    one = np.where((si < h) & (sj < w), si * w + sj, -1)
    images = 3
    want = np.concatenate([np.where(one >= 0, one + b * h * w, -1)
                           for b in range(images)])
    np.testing.assert_array_equal(L.window_rows(images, h, w, ws, shift),
                                  want)
    np.testing.assert_array_equal(
        L.residual_rows(images, h, w, ws, shift),
        np.concatenate([inv + b * hp * wp for b in range(images)]))


def test_the_kernels_divisions_are_exact():
    """``n // d`` by a multiply and a shift (``_divider``) for every
    divisor the row maps take at the presets' and the odd windows, and
    powers of two and 2^31 - 1, over 2^20 random n below 2^31 and the
    edges."""
    ds = {1, 2, 3, 7, 1 << 20, 2 ** 31 - 1}
    for h, w, ws, _ in _preset_windows() + ODD_WINDOWS:
        hp, wp = L.padded(h, w, ws)
        ds |= {hp * wp, ws * ws, wp // ws, ws, h * w, w}
    n = np.concatenate([np.random.default_rng(0).integers(0, 2 ** 31,
                                                          1 << 20),
                        np.arange(1 << 12), 2 ** 31 - 1 - np.arange(64)])
    for d in sorted(ds):
        np.testing.assert_array_equal(L._div(n, d), n // d, err_msg=str(d))


def _block_inputs(dtype, h=7, w=9, c=16, images=2, ws=4, seed=11):
    """Tokens with a NaN row, a +inf and a -inf element, norm affines, and
    an attention output in window order with a NaN row."""
    g = torch.Generator().manual_seed(seed)
    hp, wp = L.padded(h, w, ws)
    x = torch.randn((images, h * w, c), generator=g)
    x[0, 3] = float("nan")
    x[1, 5, 2], x[1, 6, 7] = float("inf"), -float("inf")
    wins = torch.randn((images * hp * wp, c), generator=g)
    wins[10] = float("nan")
    w1, w2 = (1 + 0.2 * torch.randn(c, generator=g) for _ in range(2))
    b1, b2 = (0.3 * torch.randn(c, generator=g) for _ in range(2))
    return x.to(dtype), wins.to(dtype), (w1, b1), (w2, b2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shift", [0, 2])
def test_block_norm_wrappers_take_their_plain_versions_on_the_cpu(dtype,
                                                                   shift):
    """On CPU tensors B5's block launches take their plain versions, which
    equal the block's chain (B5's plain version, ``F.pad``, the window
    gathers, the add) bit for bit, NaN and inf rows included, padding
    exact zeros; nothing is counted."""
    x, wins, (w1, b1), (w2, b2) = _block_inputs(dtype)
    before = kernel_launches()
    got = swin_window_norm_cuda(x, w1, b1, 1e-6, (7, 9), 4, shift)
    assert bits_apart(got, window_norm_chain(x, w1, b1, 1e-6, (7, 9), 4,
                                             shift)) == 0
    pad = torch.from_numpy(L.window_rows(2, 7, 9, 4, shift) < 0)
    assert bool(pad.any()) and not got[pad].any()
    s, y = swin_residual_norm_cuda(x, wins, w2, b2, 1e-6, (7, 9), 4, shift)
    want_s, want_y = residual_norm_chain(x, wins, w2, b2, 1e-6, (7, 9), 4,
                                         shift)
    assert bits_apart(s, want_s) == 0 and bits_apart(y, want_y) == 0
    assert s.dtype == y.dtype == dtype and s.shape == x.shape
    assert kernel_launches() == before


def test_the_window_check_refuses_a_wrong_map():
    """B5's block launches refuse, before they launch, tokens that are
    not the map's and a shift outside the window."""
    x = torch.empty((2, 63, 16))
    with pytest.raises(ValueError, match="tokens"):
        L._window_args(x, (7, 8), 4, 0)
    with pytest.raises(ValueError, match="shift"):
        L._window_args(x, (7, 9), 4, 4)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, for the engage rule."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("case,want", [
    ("eval", True), ("train_rate0", True), ("cpu", False),
    ("train_droppath", False), ("grad", False), ("input_grad", False),
    ("ln_kernel_off", False)])
def test_which_blocks_fuse(case, want):
    """A block takes B5's two fused launches on a CUDA tensor where its
    LayerNorms take B5 and autograd records nothing, and its DropPath
    keeps both branches whole (eval, or training at rate 0); training
    with DropPath masks, autograd, the CPU and ``ln_kernel=False`` keep the
    chain."""
    blk = S.SwinBlock(16, 2, 4, shift=True, ln_kernel=case != "ln_kernel_off",
                      drop_path=0.0 if case == "train_rate0" else 0.2)
    blk.train(case.startswith("train"))
    x = torch.zeros(2, 63, 16)
    if case != "cpu":
        x = x.as_subclass(_OnCard)
    if case == "input_grad":
        blk.requires_grad_(False)
        x.requires_grad_(True)
    gen = torch.Generator().manual_seed(0)
    with contextlib.nullcontext() if case.endswith("grad") \
            else torch.no_grad():
        masks = (blk.dp1.draw(x, gen), blk.dp2.draw(x, gen))
        assert blk._fuses(x, *masks) is want


def test_the_chain_runs_where_blocks_do_not_fuse(monkeypatch):
    """Training with DropPath masks, autograd and every CPU call run the
    block's chain: a Swin's forwards there never reach the fused
    wrappers, and its outputs are the chain's."""
    def refuse(*args):
        raise AssertionError("a fused block launch off its path")
    monkeypatch.setattr(S, "swin_window_norm_cuda", refuse)
    monkeypatch.setattr(S, "swin_residual_norm_cuda", refuse)
    mod = S.SwinTransformer(16, (2, 2), (2, 4), 4, (1,), drop_path_rate=0.2)
    x = torch.randn(1, 3, 32, 48, generator=torch.Generator().manual_seed(4))
    mod.train()
    with torch.no_grad():
        mod(x, generator=torch.Generator().manual_seed(1))
    sum(o.sum() for o in mod(x)).backward()
    mod.eval()
    with torch.no_grad():
        mod(x)


# ------------------------------------------------------------------ modules

def _randomize(variables, seed):
    """Random LayerNorm affines and bias tables (flax inits them to 1, 0
    and 0.02-scale), so that a wrong mapping or formula shows."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if set(node) == {"scale", "bias"}:
            return {"scale": rng.normal(1, 0.2, node["scale"].shape),
                    "bias": rng.normal(0, 0.2, node["bias"].shape)}
        return {k: walk(v) if isinstance(v, Mapping)
                else rng.normal(0, 1, v.shape)
                if k == "relative_position_bias_table" else v
                for k, v in node.items()}
    return {"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), walk(variables["params"]))}


def _load(mod, rules, variables):
    """Strict-load flax variables, converted by ``rules`` (torch prefix
    "m."), into the port module."""
    sd = C.variables_to_state_dict(variables, rules)
    mod.load_state_dict({k[2:]: torch.from_numpy(np.array(v))
                         for k, v in sd.items()}, strict=True)
    return mod.eval()


@torch.no_grad()
@pytest.mark.parametrize("h,w", [(7, 9), (8, 6)])
def test_patch_merging_matches_jax(h, w):
    """Unfold channel order c*4 + ky*2 + kx, zero padding of odd sides."""
    c = 8
    x = np.random.default_rng(2).normal(0, 1, (2, h * w, c)).astype(
        np.float32)
    fl = JPatchMerging(out_dim=2 * c)
    v = _randomize(jax.jit(fl.init, static_argnums=2)(
        jax.random.PRNGKey(0), x, (h, w)), 2)
    want, want_hw = fl.apply(v, jnp.asarray(x), (h, w))
    mod = _load(S.PatchMerging(c), [("m.norm", ("norm",), C.LN),
                                    ("m.reduction", ("reduction",), C.DENSE)],
                v)
    got, got_hw = mod(torch.from_numpy(x), (h, w))
    assert got_hw == tuple(want_hw)
    assert _rel_to_peak(got.numpy(), want) < 2e-4


@torch.no_grad()
@pytest.mark.parametrize("shift", [True, False])
def test_swin_block_matches_jax(shift):
    """A block on a 7x9 map with window 4: padding, and with the shift the
    cyclic roll and the -100 mask."""
    c, heads, ws, hw = 16, 2, 4, (7, 9)
    x = np.random.default_rng(3).normal(0, 1, (2, 63, c)).astype(np.float32)
    fl = JSwinBlock(c, heads, ws, shift=shift, drop_path=0.0)
    v = _randomize(jax.jit(fl.init, static_argnums=2)(
        jax.random.PRNGKey(1), x, hw), 3)
    want = jax.jit(fl.apply, static_argnums=2)(v, jnp.asarray(x), hw)
    mod = _load(S.SwinBlock(c, heads, ws, shift), C._swin_block("m", ()), v)
    got = mod(torch.from_numpy(x), hw)
    assert _rel_to_peak(got.numpy(), want) < 2e-4


SWIN_CASES = {
    # name: (window, (H, W), return_stereo_feat, stage0_only)
    "window4_stereo": (4, (32, 48), True, False),
    "window5_nondivisible": (5, (28, 44), False, False),
    "window4_stage0_only": (4, (32, 48), True, True),
}


@pytest.fixture(scope="module", params=sorted(SWIN_CASES))
def small_swin(request):
    """The small Swin of tests/test_swin.py (embed 16, depths (2, 2), heads
    (2, 4), out index 1): one jitted JAX init and apply per case."""
    ws, (h, w), stereo, stage0 = SWIN_CASES[request.param]
    fl = JSwinTransformer(embed_dims=16, depths=(2, 2), num_heads=(2, 4),
                          out_indices=(1,), window_size=ws,
                          return_stereo_feat=stereo)
    x = np.random.default_rng(4).normal(0, 1, (2, h, w, 3)).astype(
        np.float32)
    v = _randomize(jax.jit(fl.init)(jax.random.PRNGKey(2), x), 4)
    want = jax.jit(lambda v, x: fl.apply(v, x, stage0_only=stage0))(
        v, jnp.asarray(x))
    mod = _load(S.SwinTransformer(16, (2, 2), (2, 4), ws, (1,), stereo),
                C._swin("m", (), (2, 2), (1,)), v)
    return mod, x, stage0, want


@torch.no_grad()
def test_swin_transformer_matches_jax(small_swin):
    mod, x, stage0, want = small_swin
    got = mod(torch.from_numpy(np.moveaxis(x, -1, 1).copy()),
              stage0_only=stage0)
    if stage0:
        got, want = [got], [want]
    else:
        assert len(got) == len(want) == len(mod.out_channels)
    for g, wnt, ch in zip(got, want, mod.out_channels):
        assert g.shape[1] == ch
        assert _rel_to_peak(np.moveaxis(g.numpy(), 1, -1), wnt) < 2e-4


@torch.no_grad()
def test_layer_norm_weights_stay_fp32_in_a_bf16_swin():
    """A bf16 Swin keeps its LayerNorm affines in fp32 (JAX keeps them
    fp32, dhd_tpu/nn/swin.py:120-121): values that bf16 cannot hold survive
    ``.to(bfloat16)`` and a load, and the norm matches JAX's bf16
    FusedLayerNorm with fp32 parameters within one bf16 ulp."""
    mod = S.SwinTransformer(16, (2, 2), (2, 4), 4, (1,)).to(torch.bfloat16)
    ln = mod.stages[0].blocks[0].norm1
    assert ln.weight.dtype == ln.bias.dtype == torch.float32
    assert mod.stages[0].blocks[0].attn.w_msa.qkv.weight.dtype == \
        torch.bfloat16
    rng = np.random.default_rng(5)
    scale = (1 + rng.normal(0, 1e-3, 16)).astype(np.float32)
    bias = rng.normal(0, 1e-3, 16).astype(np.float32)
    ln.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias)})
    assert np.array_equal(ln.weight.numpy(), scale)
    x = jnp.asarray(rng.normal(0, 1, (3, 20, 16)), jnp.bfloat16)
    want = JFusedLayerNorm(dtype=jnp.bfloat16).apply(
        {"params": {"scale": scale, "bias": bias}}, x)
    got = ln(torch.from_numpy(np.asarray(x, np.float32)).bfloat16())
    assert got.dtype == torch.bfloat16
    assert _bf16_ulps(_f32(got), _f32(want)) <= 1
    out = mod(torch.randn(1, 3, 32, 48, generator=torch.Generator()
                          .manual_seed(0)).bfloat16())
    assert all(bool(torch.isfinite(o.float()).all()) for o in out)
