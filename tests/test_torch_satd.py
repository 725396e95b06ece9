"""K1, the fused SATD mode search: its plain PyTorch version against the JAX
package (predict_all_modes_mm + cost.satd, and the Pallas kernel in
interpret mode), exact; and the CUDA kernel against the plain version,
which needs a card and skips without one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevctpu.ops import cost as jcost
from hevctpu.ops import intra as jintra
from hevctpu.ops import intra_mm as jintra_mm
from hevctpu.ops import satd_fused as jsatd
from hevctpu_torch.ops import intra_mm, satd_fused


def _inputs(rng, m, n):
    ext = lambda: rng.integers(0, 256, (m, 2 * n + 1)).astype(np.int32)
    top_e, left_e = ext(), ext()
    top_f, left_f = (np.asarray(x) for x in jintra.smooth_reference(
        jnp.asarray(top_e), jnp.asarray(left_e), n))
    blocks = rng.integers(0, 256, (m, n, n)).astype(np.int32)
    return top_e, left_e, top_f, left_f, blocks


def _t(xs):
    return [torch.as_tensor(np.array(x)) for x in xs]


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("is_luma", [True, False])
def test_plain_k1_matches_jax_unfused(n, is_luma):
    rng = np.random.default_rng(n)
    inp = _inputs(rng, 37, n)              # M = 37: not a tile multiple
    want = np.asarray(jax.jit(lambda te, le, tf, lf, b: jcost.satd(
        jintra_mm.predict_all_modes_mm(te, le, tf, lf, n, is_luma=is_luma),
        b[:, None]))(*(jnp.asarray(x) for x in inp)))
    launches = satd_fused.LAUNCHES
    got = satd_fused.dense_mode_costs(*_t(inp), n, is_luma=is_luma).numpy()
    np.testing.assert_array_equal(got, want)
    assert satd_fused.LAUNCHES == launches     # CPU tensors: plain version


def test_plain_k1_matches_pallas_interpret():
    rng = np.random.default_rng(8)
    n = 8
    inp = _inputs(rng, 37, n)
    want = np.asarray(jsatd.dense_mode_costs(
        *(jnp.asarray(x) for x in inp), n, interpret=True))
    got = satd_fused.dense_mode_costs(*_t(inp), n).numpy()
    np.testing.assert_array_equal(got, want)
    # the unpatched kernel function itself
    refs = intra_mm.pack_refs(*_t(inp[:4]))
    want = np.asarray(jsatd.mode_satd_costs(
        jnp.asarray(refs.numpy()), jnp.asarray(inp[4].reshape(37, 64)), n,
        interpret=True))
    got = satd_fused.mode_satd_costs(refs, torch.as_tensor(
        inp[4].reshape(37, 64)), n).numpy()
    np.testing.assert_array_equal(got, want)


def test_leading_axes():
    rng = np.random.default_rng(7)
    n, shape = 8, (2, 3, 5)
    m = int(np.prod(shape))
    inp = _t(_inputs(rng, m, n))
    got = satd_fused.dense_mode_costs(
        *(x.reshape(shape + x.shape[1:]) for x in inp), n)
    assert got.shape == shape + (35,)
    want = satd_fused.dense_mode_costs(*inp, n)
    np.testing.assert_array_equal(got.reshape(m, 35).numpy(), want.numpy())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K1 kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("is_luma", [True, False])
def test_cuda_kernel_matches_plain(cuda_device, n, is_luma):
    rng = np.random.default_rng(n)
    inp = _inputs(rng, 37, n)
    refs = intra_mm.pack_refs(*_t(inp[:4])).to(cuda_device).contiguous()
    orig = torch.as_tensor(inp[4].reshape(37, n * n)).to(cuda_device)
    launches = satd_fused.LAUNCHES
    got = satd_fused.mode_satd_costs(refs, orig, n, is_luma=is_luma)
    torch.cuda.synchronize()
    assert satd_fused.LAUNCHES == launches + 1
    want = satd_fused.mode_satd_costs_ref(refs, orig, n, is_luma=is_luma)
    assert torch.equal(got, want)
