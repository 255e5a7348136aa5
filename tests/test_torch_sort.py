"""The port's sorted_l1 and value sort (deltakd_tpu_torch/ops/sort.py) against
the JAX package's: the plain PyTorch versions (the autograd Function with its
sign residual, and the autograd-through-sort reference) against the XLA
sorting network `_sorted_l1_network` and the Pallas kernel `sorted_l1_pallas`
run in interpret mode; and the value sort's key images (``value_sort_keys``,
the image the kernel sorts, and ``value_from_keys``, its decode) in bf16,
fp16, fp32 and int32 against np.sort and JAX `bitonic_sort`.

fp32 on the CPU, inputs from a numpy seed. On tie-free inputs the terms are
the same and only the fp32 summation order differs: value and gradient to
rtol 1e-5. With ties (bf16-rounded inputs) the sorted values are exact, the
loss holds to rtol 1e-5, and the gradient is compared after summing over each
group of tied rows in a column (the split inside a group is a free choice of
subgradient). Where a sorted s equals the sorted t, the port and the Pallas
kernel give the gradient sign(0) = 0 while autodiff through the XLA network
gives jnp.abs's +1, another valid subgradient: so the network is compared on
inputs with ties inside s but no s equal to a t, the Pallas kernel also with
such equalities planted. The kernels themselves run only on a card
(tests/test_torch_cuda.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltakd_tpu.ops import fused_block as jfb
from deltakd_tpu.ops import sort as jsort
from deltakd_tpu_torch.ops import sort as tsort

torch.set_num_threads(1)


def _inputs(shape, seed, ties=False, s_equals_t=False):
    rng = np.random.RandomState(seed)
    s = rng.randn(*shape).astype(np.float32)
    t = rng.randn(*shape).astype(np.float32)
    if ties:
        # bf16 rounding of a coarse draw ties many values (t lies between the
        # values of s); plant exact duplicates within s
        s = torch.from_numpy(np.round(s * 4) / 4).bfloat16().float().numpy()
        t = torch.from_numpy(np.round(t * 4) / 4 + 0.125).bfloat16().float().numpy()
        s[:, 1] = s[:, 0]
    if s_equals_t:
        t[:, :3] = s[:, :3]
    return s, t


def _torch_value_and_grad(fn, s, t, axis, dtype=torch.float32):
    ts = torch.from_numpy(s).to(dtype).requires_grad_(True)
    tt = torch.from_numpy(t).to(dtype).requires_grad_(True)
    loss = fn(ts, tt, axis)
    gs, gt = torch.autograd.grad(loss, [ts, tt], allow_unused=True)
    return loss, gs, gt


@functools.lru_cache(maxsize=None)
def _jax_results(shape, seed, ties=False, s_equals_t=False):
    """((value, grad) of the XLA network, (value, grad) of the Pallas kernel in
    interpret mode) on `_inputs(...)`, as numpy; computed once per input."""
    s, t = _inputs(shape, seed, ties, s_equals_t)
    net = jax.jit(jax.value_and_grad(
        lambda x: jsort._sorted_l1_network(x, jnp.asarray(t), axis=1)))(jnp.asarray(s))
    jfb.set_interpret(True)
    try:
        pallas = jax.value_and_grad(
            lambda x: jsort.sorted_l1_pallas(x, jnp.asarray(t), axis=1))(jnp.asarray(s))
    finally:
        jfb.set_interpret(False)
    return tuple((float(v), np.asarray(g)) for v, g in (net, pallas))


def _tie_group_sums(g, s):
    """Per column (b, :, j), the gradient summed over rows with equal s."""
    g, s = np.asarray(g, np.float64), np.asarray(s)
    out = np.zeros_like(g)
    B, n, d = s.shape
    for b in range(B):
        for j in range(d):
            _, inv = np.unique(s[b, :, j], return_inverse=True)
            sums = np.zeros(inv.max() + 1)
            np.add.at(sums, inv, g[b, :, j])
            out[b, :, j] = sums[inv]
    return out


@pytest.mark.parametrize("shape", [(4, 10, 128), (40, 6, 128)],
                         ids=["b4", "ragged-b40-crosses-the-jax-chunk"])
@pytest.mark.parametrize("fn", [tsort.sorted_l1, tsort.sorted_l1_reference],
                         ids=["function", "reference"])
def test_sorted_l1_matches_network_and_interpreted_pallas(fn, shape):
    s, t = _inputs(shape, 7)
    (v_net, g_net), (v_pl, g_pl) = _jax_results(shape, 7)
    tsort.reset_launches()
    loss, gs, gt = _torch_value_and_grad(fn, s, t, 1)
    assert loss.dtype == torch.float32 and not tsort.LAUNCHES
    for v, g in ((v_net, g_net), (v_pl, g_pl)):
        np.testing.assert_allclose(loss.item(), float(v), rtol=1e-5)
        np.testing.assert_allclose(gs.numpy(), np.asarray(g), rtol=1e-5, atol=1e-8)
    assert gt is None or float(gt.abs().max()) == 0.0


@pytest.mark.parametrize("s_equals_t", [False, True])
@pytest.mark.parametrize("fn", [tsort.sorted_l1, tsort.sorted_l1_reference],
                         ids=["function", "reference"])
def test_sorted_l1_with_ties(fn, s_equals_t):
    s, t = _inputs((3, 12, 128), 3, ties=True, s_equals_t=s_equals_t)
    assert len(np.unique(s[0, :, 0])) < s.shape[1]
    np.testing.assert_array_equal(
        tsort.bitonic_sort(torch.from_numpy(s), axis=1).numpy(),
        np.asarray(jsort.bitonic_sort(jnp.asarray(s), axis=1)))
    loss, gs, gt = _torch_value_and_grad(fn, s, t, 1)
    (v_net, g_net), (v_pl, g_pl) = _jax_results((3, 12, 128), 3, True, s_equals_t)
    mine = _tie_group_sums(gs.numpy(), s)
    for v, g in ((v_net, g_net), (v_pl, g_pl)):
        np.testing.assert_allclose(loss.item(), float(v), rtol=1e-5)
        if g is g_pl or not s_equals_t:
            np.testing.assert_allclose(mine, _tie_group_sums(g, s), rtol=1e-5, atol=1e-9)
    assert gt is None or float(gt.abs().max()) == 0.0
    # stable order: the Function and the autograd reference agree row by row
    _, g_ref, _ = _torch_value_and_grad(tsort.sorted_l1_reference, s, t, 1)
    _, g_fn, g_t = _torch_value_and_grad(tsort.sorted_l1, s, t, 1)
    assert torch.equal(g_ref, g_fn) and float(g_t.abs().max()) == 0.0


def test_sorted_l1_in_bf16_sorts_in_bf16_and_reduces_in_fp32():
    s, t = _inputs((2, 9, 16), 5, ties=True, s_equals_t=True)
    loss, gs, _ = _torch_value_and_grad(tsort.sorted_l1, s, t, 1, torch.bfloat16)
    ref, g_ref, _ = _torch_value_and_grad(tsort.sorted_l1_reference, s, t, 1, torch.bfloat16)
    v = jsort._sorted_l1_network(jnp.asarray(s, jnp.bfloat16), jnp.asarray(t, jnp.bfloat16), 1)
    assert loss.dtype == torch.float32 and gs.dtype == torch.bfloat16
    np.testing.assert_allclose(loss.item(), float(v), rtol=1e-5)
    assert loss.item() == ref.item() and torch.equal(gs, g_ref)


@pytest.mark.parametrize("n", [2, 33, 257])
def test_sorted_l1_matches_network_at_kernel_lengths(n):
    """n = 2 (one key a lane in the forward kernel's network), 33 (two) and
    257 (padded to 512); column 0 of s holds -0.0 and +0.0 ties, the -0.0 at
    the later rows. Against the jitted XLA network (not the interpreted
    Pallas kernel); the gradient is compared after summing over tied rows."""
    s, t = _inputs((2, n, 24), 13)
    s[:, ::2, 0], s[:, 1::2, 0] = 0.0, -0.0
    v, g = jax.jit(jax.value_and_grad(
        lambda x: jsort._sorted_l1_network(x, jnp.asarray(t), axis=1)))(jnp.asarray(s))
    tsort.reset_launches()
    loss, gs, gt = _torch_value_and_grad(tsort.sorted_l1, s, t, 1)
    assert not tsort.LAUNCHES
    np.testing.assert_allclose(loss.item(), float(v), rtol=1e-5)
    np.testing.assert_allclose(_tie_group_sums(gs.numpy(), s), _tie_group_sums(g, s),
                               rtol=1e-5, atol=1e-9)
    assert float(gt.abs().max()) == 0.0
    # stable order: the -0.0 rows follow the +0.0 rows they tie with
    _, g_ref, _ = _torch_value_and_grad(tsort.sorted_l1_reference, s, t, 1)
    assert torch.equal(gs, g_ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_packed_sort_keys_order_as_the_stable_sort(dtype):
    """``sort_keys`` (the forward kernel's packing of a value and its row):
    ascending key order equals torch.sort(stable=True)'s indices, with -0.0
    tied to +0.0 in both orders of rows, +-inf, NaN of both signs, and ties."""
    rng = np.random.RandomState(17)
    x = torch.from_numpy(rng.randn(3, 40, 7).astype(np.float32)).bfloat16().to(dtype)
    x[:, 0], x[:, 5], x[:, 13], x[:, 14] = 0.0, -0.0, -0.0, 0.0
    x[:, 7], x[:, 9], x[:, 11] = float("inf"), -float("inf"), float("inf")
    x[:, 20] = x[:, 21]
    x[0, 30], x[0, 31], x[1, 2] = float("nan"), -float("nan"), float("nan")
    keys = tsort.sort_keys(x)
    order = torch.sort(keys, dim=1)
    assert keys.dtype == torch.int64 and bool((order.values.diff(dim=1) > 0).all())
    assert torch.equal(order.indices, torch.sort(x, dim=1, stable=True).indices)
    # the row index is the low bits; -0.0 and +0.0 have one image
    assert torch.equal(keys & 0xffff, torch.arange(40).view(1, -1, 1).expand(3, 40, 7))
    zero = keys[:, [0, 5, 13, 14], :] >> (16 if dtype == torch.bfloat16 else 32)
    assert bool((zero == zero[:, :1]).all())
    with pytest.raises(ValueError):
        tsort.sort_keys(x.double())


@pytest.mark.parametrize("shape,axis", [((5, 7, 6), 2), ((5, 7, 6), 0), ((5, 7, 6), -2),
                                        ((9, 4), 0), ((3, 4, 5, 2), 2)])
def test_other_axes_go_through_the_same_layout(shape, axis):
    s, t = _inputs(shape, 11)
    v, g = jax.jit(jax.value_and_grad(
        lambda x: jsort._sorted_l1_network(x, jnp.asarray(t), axis=axis)))(jnp.asarray(s))
    loss, gs, _ = _torch_value_and_grad(tsort.sorted_l1, s, t, axis)
    np.testing.assert_allclose(loss.item(), float(v), rtol=1e-5)
    np.testing.assert_allclose(gs.numpy(), np.asarray(g), rtol=1e-5, atol=1e-8)
    np.testing.assert_array_equal(
        tsort.bitonic_sort(torch.from_numpy(s), axis=axis).numpy(), np.sort(s, axis=axis))


_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16, "fp32": torch.float32,
           "int32": torch.int32}
_JAX_DTYPES = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16,
               torch.float32: jnp.float32, torch.int32: jnp.int32}


def _value_inputs(shape, dtype, seed, nan=False):
    """A tensor with many ties and a tenth of its elements special: +-0.0 and
    +-inf (and NaN) for a float, the int32 extremes, 0 and -1 for int32."""
    rng = np.random.RandomState(seed)
    if dtype == torch.int32:
        x = rng.randint(-40, 40, size=shape).astype(np.int32)
        info = np.iinfo(np.int32)
        specials = [info.min, info.max, 0, -1, info.max - 1]
    else:
        x = (np.round(rng.randn(*shape) * 4) / 4).astype(np.float32)
        specials = [0.0, -0.0, np.inf, -np.inf, -0.0] + ([np.nan] if nan else [])
    idx = rng.choice(x.size, max(len(specials), x.size // 10), replace=False)
    x.flat[idx] = np.resize(np.asarray(specials, x.dtype), len(idx))
    return torch.from_numpy(x).to(dtype)


def _image_sort(x):
    """What the value-sort kernel computes, in plain PyTorch: sort the key
    images along axis 1 and decode them."""
    return tsort.value_from_keys(torch.sort(tsort.value_sort_keys(x), dim=1).values, x.dtype)


def _negative_zeros(x):
    """The count of -0.0 in each column of a [B, n, d] tensor."""
    if not x.dtype.is_floating_point:
        return torch.zeros(x.shape[0], x.shape[2], dtype=torch.int64)
    return ((x == 0) & torch.signbit(x)).sum(dim=1)


@pytest.mark.parametrize("dtype", list(_DTYPES.values()), ids=list(_DTYPES))
def test_value_sort_keys_order_as_the_values(dtype):
    """a < b gives image(a) < image(b); equal values give equal images except
    -0.0, whose image is +0.0's less one; every NaN takes the largest image,
    above every other value's."""
    v = _value_inputs((1, 96, 1), dtype, 5, nan=dtype.is_floating_point).flatten()
    k = tsort.value_sort_keys(v)
    a = v.double()
    less = a[:, None] < a[None, :]
    assert bool((k[:, None] < k[None, :])[less].all())
    neg_zero = (a == 0) & torch.signbit(a)
    equal = (a[:, None] == a[None, :]) & (neg_zero[:, None] == neg_zero[None, :])
    assert bool((k[:, None] == k[None, :])[equal].all())
    if dtype.is_floating_point:
        mask = (1 << (16 if dtype.itemsize == 2 else 32)) - 1
        nan = torch.isnan(a)
        assert bool(nan.any()) and bool((k[nan] == mask).all()) and bool((k[~nan] < mask).all())
        assert bool(neg_zero.any())
        assert bool((k[neg_zero] == k[(a == 0) & ~neg_zero][0] - 1).all())
    with pytest.raises(ValueError):
        tsort.value_sort_keys(v.double())


@pytest.mark.parametrize("dtype", list(_DTYPES.values()), ids=list(_DTYPES))
def test_value_sort_keys_decode_to_the_same_bits(dtype):
    """value_from_keys(value_sort_keys(x)) gives x's bits back for every value
    but a NaN, over random bit patterns, -0.0 and the extremes included; a
    NaN comes back as a NaN."""
    rng = np.random.RandomState(23)
    ints = torch.int16 if dtype.itemsize == 2 else torch.int32
    info = torch.iinfo(ints)
    bits = torch.from_numpy(rng.randint(info.min, info.max, size=8192, dtype=np.int64))
    bits = torch.cat([bits, torch.tensor([info.min, info.max, 0, -1])]).to(ints)
    x = bits.view(dtype)
    back = tsort.value_from_keys(tsort.value_sort_keys(x), dtype)
    keep = ~torch.isnan(x) if dtype.is_floating_point else torch.ones_like(bits, dtype=torch.bool)
    assert torch.equal(back.view(ints)[keep], bits[keep])
    if dtype.is_floating_point:
        assert bool((~keep).any()) and bool(torch.isnan(back[~keep]).all())


@pytest.mark.parametrize("n", [2, 33, 196, 1024])
@pytest.mark.parametrize("dtype", list(_DTYPES.values()), ids=list(_DTYPES))
def test_sorted_images_match_numpy_and_jax(dtype, n):
    """Sorting the key images and decoding (the value-sort kernel's
    arithmetic) equals np.sort and the JAX package's bitonic_sort (its XLA
    network on the CPU) along axis 1, with ties, +-0.0, +-inf and the int32
    extremes; the -0.0s keep their signs; the port's CPU path agrees."""
    x = _value_inputs((2, n, 5), dtype, n)
    out = _image_sort(x)
    assert out.dtype == dtype
    as_np = (lambda t: t.float().numpy()) if dtype.is_floating_point else (lambda t: t.numpy())
    np.testing.assert_array_equal(as_np(out), np.sort(as_np(x), axis=1))
    jx = jnp.asarray(as_np(x)).astype(_JAX_DTYPES[dtype])
    j_out = np.asarray(jsort.bitonic_sort(jx, axis=1)).astype(as_np(x).dtype)
    np.testing.assert_array_equal(as_np(out), j_out)
    assert torch.equal(tsort.bitonic_sort(x, axis=1), out)
    assert torch.equal(_negative_zeros(out), _negative_zeros(x))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "fp16", "fp32"])
def test_sorted_images_put_nan_last_as_torch_sort(dtype):
    """With NaNs: the image sort equals torch.sort's values, each column's
    NaNs last and as many as it had, the -0.0 counts kept."""
    x = _value_inputs((3, 196, 7), dtype, 9, nan=True)
    x[0, :, 0] = float("nan")   # a column of NaNs alone
    out, ref = _image_sort(x), torch.sort(x, dim=1).values
    nan = torch.isnan(ref)
    assert bool(nan.any()) and torch.equal(torch.isnan(out), nan)
    assert torch.equal(out[~nan], ref[~nan])
    assert torch.equal(_negative_zeros(out), _negative_zeros(x))


def test_kernel_wrappers_raise_on_what_the_kernels_do_not_take():
    """A CPU tensor never reaches a kernel wrapper by dispatch; called
    directly, the wrappers raise instead of falling back."""
    ok = torch.zeros(2, 4, 8)
    for bad in (torch.zeros(2, 1, 8), torch.zeros(2, 1025, 8), torch.zeros(4, 8),
                torch.zeros(2, 4, 8, dtype=torch.float64), ok):
        with pytest.raises(ValueError):
            tsort.bitonic_sort_kernel(bad)
        with pytest.raises(ValueError):
            tsort.kernel_sorted_l1_fwd(bad, bad)
    # fp16 and int32: the value sort takes them (refused here only for lying
    # on the CPU), the sorted_l1 forward does not
    for dtype in (torch.float16, torch.int32):
        x = torch.zeros(2, 4, 8, dtype=dtype)
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            tsort.bitonic_sort_kernel(x)
        with pytest.raises(ValueError, match="takes a"):
            tsort.kernel_sorted_l1_fwd(x, x)
    with pytest.raises(ValueError, match="takes a"):
        tsort.bitonic_sort_kernel(torch.zeros(2, 4, 8, dtype=torch.float64))
    with pytest.raises(ValueError):
        tsort.kernel_sorted_l1_bwd(torch.zeros(2, 4, 8, dtype=torch.int8),
                                   torch.tensor(1.0), torch.float32)
    with pytest.raises(ValueError):
        tsort.sorted_l1(ok, torch.zeros(2, 4, 7), 1)
    assert not tsort.LAUNCHES
