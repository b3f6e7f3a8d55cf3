"""K8's plain version against the JAX package's `instance_norm_fused`.

On the CPU the port's wrapper `instance_norm_fused` runs its plain
version; the JAX side runs its two Pallas kernels (`_stats_kernel`,
`_norm_kernel`) in interpret mode, or its fallback (`instance_norm` /
`instance_norm_phase`) where H*W is not a multiple of 8. Also the port's
`instance_norm_phase` against the JAX package's (`ops/upconv.py`), the
phase identity with `ops/warp.py:space_to_depth`, the degenerate-channel
case of tests/test_fuse_clip.py:49-61 and the wrapper's refusals; the
planner `fused_plan` (which path, slab, cluster, pixels a block and shared
memory) at the standalone shapes, at the phase decoder's norms and at
shapes each path must take, a model of the cluster kernel's index map that
covers every (sample, channel, pixel) exactly once, and `fused_launcher`'s
refusals. The CUDA kernel itself is held against the plain version on the
GPU (tests/test_torch_cuda.py, chip_smoke.py).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wacv23_tsnet_tpu.ops.pallas_norms import \
    instance_norm_fused as j_in_fused
from wacv23_tsnet_tpu.ops.upconv import instance_norm_phase as j_in_phase
from wacv23_tsnet_tpu_torch.ops import cuda_build
from wacv23_tsnet_tpu_torch.ops.norm_kernels import (FUSED_PATHS,
                                                     FUSED_THREADS,
                                                     MAX_FUSED_CLUSTER,
                                                     REG_CHUNKS,
                                                     fused_launcher,
                                                     fused_plan,
                                                     instance_norm_fused,
                                                     instance_norm_fused_plain)
from wacv23_tsnet_tpu_torch.ops.norms import (instance_norm,
                                              instance_norm_phase)
from wacv23_tsnet_tpu_torch.ops.warp import space_to_depth

torch.set_num_threads(2)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _x(seed, shape) -> np.ndarray:
    """Activations with a per-channel offset, so the mean matters."""
    rng = np.random.default_rng(seed)
    offset = rng.standard_normal(shape[-1]) * 2
    return (rng.standard_normal(shape) * 1.5 + offset).astype(np.float32)


def _check(got: torch.Tensor, want, dtype: str, atol: float = 1e-5):
    """f32 within `atol`; bf16 within one bf16 step of the JAX value
    (2^-7 relative): both round an fp32 result once, and the two sides'
    fp32 sums, taken in another order, may put a value a rounding away
    from a tie on the other side of it."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    err = np.abs(got - want)
    # the measured error, shown by `pytest -s`
    print(f"[parity] {os.environ.get('PYTEST_CURRENT_TEST', '').split()[0]}: "
          f"max_abs_err={err.max():.3e}")
    rtol = 2.0 ** -7 if dtype == "bf16" else 0.0
    assert (err <= atol + rtol * np.abs(want)).all(), err.max()


# (B, H, W, C): square, and a non-square plane (H*W a multiple of 8, so
# JAX runs its Pallas kernels)
SHAPES = {"square": (2, 8, 8, 32), "rect": (1, 4, 16, 64)}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("relu", [False, True], ids=["norm", "relu"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_in_fused_plain_matches_jax_pallas(dtype, relu, groups, shape):
    jdt, tdt = DTYPES[dtype]
    x = _x(0, SHAPES[shape])
    want = j_in_fused(jnp.asarray(x, jdt), relu=relu, phase_groups=groups)
    cuda_build.reset_launches()
    got = instance_norm_fused(torch.from_numpy(x).to(tdt), relu=relu,
                              phase_groups=groups)
    assert set(cuda_build.LAUNCHES.values()) == {0}
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    _check(got, want, dtype)


@pytest.mark.parametrize("groups", [1, 4])
def test_in_fused_plain_matches_jax_fallback(groups):
    """H*W = 35, not a multiple of 8: JAX takes `instance_norm` /
    `instance_norm_phase` (two-pass in f32), the port its one-pass plain
    version; within 1e-4."""
    x = _x(1, (2, 5, 7, 16))
    want = j_in_fused(jnp.asarray(x), relu=True, phase_groups=groups)
    got = instance_norm_fused(torch.from_numpy(x), relu=True,
                              phase_groups=groups)
    _check(got, want, "f32", atol=1e-4)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_instance_norm_phase_matches_jax(dtype):
    """f32 within 1e-5 (two-pass on both sides); bf16 one-pass on both,
    within one bf16 step."""
    jdt, tdt = DTYPES[dtype]
    x = _x(2, (2, 6, 4, 4 * 12))
    want = j_in_phase(jnp.asarray(x, jdt))
    got = instance_norm_phase(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    _check(got, want, dtype)


def test_phase_groups_match_the_interleaved_norm():
    """The phase layout of `space_to_depth(x, 2)` with `phase_groups=4`
    normalises as the interleaved tensor does, for the fused norm and for
    `instance_norm_phase`."""
    x = torch.from_numpy(_x(3, (2, 8, 12, 16)))
    want = space_to_depth(instance_norm_fused(x, relu=True), 2)
    got = instance_norm_fused(space_to_depth(x, 2), relu=True,
                              phase_groups=4)
    assert (got - want).abs().max().item() <= 1e-5
    phase = instance_norm_phase(space_to_depth(x, 2))
    assert (phase - space_to_depth(instance_norm(x), 2)).abs().max() <= 1e-5


def test_degenerate_channel_is_finite():
    """A near-constant channel with a large mean makes the one-pass
    variance cancel below 0 in fp32; clamped, the output stays finite
    (tests/test_fuse_clip.py:49-61)."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy((300.0 + rng.standard_normal((2, 8, 8, 16)) * 1e-3)
                         .astype(np.float32)).to(torch.bfloat16)
    for y in (instance_norm_phase(x), instance_norm_fused(x),
              instance_norm_fused(x, phase_groups=4),
              instance_norm_fused_plain(x.float(), phase_groups=4)):
        assert bool(torch.isfinite(y.float()).all())


def _meta(*shape, dtype=torch.bfloat16, grad=False):
    return torch.empty(*shape, device="meta", dtype=dtype,
                       requires_grad=grad)


REFUSALS = {
    "not_cuda": (lambda: instance_norm_fused(_meta(2, 4, 4, 16)),
                 "CUDA tensors"),
    "requires_grad": (lambda: instance_norm_fused(
        _meta(2, 4, 4, 16, dtype=torch.float32, grad=True)),
        "inference only"),
    "rank": (lambda: instance_norm_fused(_meta(4, 4, 16)),
             r"\(B, H, W, C\)"),
    "groups": (lambda: instance_norm_fused(_meta(2, 4, 4, 18),
                                           phase_groups=4), "multiple"),
    "float16": (lambda: instance_norm_fused(
        _meta(2, 4, 4, 16, dtype=torch.float16)), "bfloat16"),
    "not_contiguous": (lambda: instance_norm_fused(
        _meta(2, 4, 4, 16).transpose(1, 2)), "contiguous"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_in_fused_wrapper_refuses_what_the_kernel_does_not_take(case):
    """Off the CPU the wrapper launches its kernel or raises: a tensor
    that requires grad while grad mode is on (the kernel has no
    gradient), a wrong rank, C off the phase groups, another dtype, a
    strided view or a device with no kernel; nothing is sent to the plain
    version."""
    call, match = REFUSALS[case]
    cuda_build.reset_launches()
    with pytest.raises(ValueError, match=match):
        call()
    assert set(cuda_build.LAUNCHES.values()) == {0}


def test_in_fused_grad_refusal_follows_grad_mode():
    """Under no_grad a tensor that requires grad is no reason to refuse:
    the call goes on to the device check."""
    x = _meta(2, 4, 4, 16, dtype=torch.float32, grad=True)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        instance_norm_fused(x)


# the H100's shared memory a block can take (227 KB)
SMEM_LIMIT = 232448
# chip_smoke.py's K8_SHAPES: phase_groups -> (B, H, W, C)
K8_SHAPES = {1: (32, 256, 256, 64), 4: (32, 128, 128, 256)}


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("groups", list(K8_SHAPES), ids=["g1", "g4"])
def test_fused_plan_at_the_standalone_shapes(groups, itemsize):
    """A slab is 64 bytes of channels a group, so a unit (sample, slab)
    is N * G * 64 bytes = 4 MiB at all four cases, spread over a cluster
    of 16 blocks of 256 KiB each: 48 KiB in registers (12 chunks of 16
    bytes a thread) and 208 KiB of shared memory."""
    b, h, w, c = K8_SHAPES[groups]
    n = h * w
    plan = fused_plan(n, c, groups, itemsize)
    assert plan.path == "cluster"
    assert plan.slab * itemsize == 64
    assert n * groups * plan.slab * itemsize == 4 << 20
    assert plan.cluster * plan.rows_per_block == n
    in_registers = REG_CHUNKS * FUSED_THREADS * 16
    assert (plan.smem_bytes + in_registers) * plan.cluster == 4 << 20
    assert plan.smem_bytes == 208 << 10 <= SMEM_LIMIT
    assert plan.cluster == MAX_FUSED_CLUSTER == 16


# the phase decoder's norms of a 64-frame face chunk: name -> (N, C, G)
# and the plan's (cluster, pixels a block, shared memory a block)
DECODER_PLANS = {"block": ((1024, 512, 1), (1, 1024, 16 << 10)),
                 "up0": ((1024, 1024, 4), (1, 1024, 208 << 10)),
                 "up1": ((4096, 512, 4), (4, 1024, 208 << 10)),
                 "up2": ((16384, 256, 4), (16, 1024, 208 << 10))}


@pytest.mark.parametrize("name", list(DECODER_PLANS))
def test_fused_plan_takes_the_fewest_blocks_at_the_decoder_norms(name):
    """A unit takes as few blocks as hold it, in registers and at most 208
    KiB of shared memory each: one block at the 1024-pixel planes, where
    16 blocks of 64 pixels ran up to 10x slower on the H100."""
    (n, c, groups), want = DECODER_PLANS[name]
    plan = fused_plan(n, c, groups, 2)
    assert plan.path == "cluster" and plan.slab == 32
    assert (plan.cluster, plan.rows_per_block, plan.smem_bytes) == want
    assert plan.cluster == -(-n // plan.rows_per_block)
    assert plan.smem_bytes <= SMEM_LIMIT


# (n, C, G, itemsize, aligned) -> why the three-launch path takes it
THREE_LAUNCH = {
    "unit_past_cluster": (512 * 512, 16, 1, 2, True),
    "chunk_off_group": (64, 12, 1, 2, True),
    "f32_chunk_off_group": (64, 24, 4, 4, True),
    "unaligned": (64, 64, 1, 4, False),
    "slots_past_threads": (64, 2 * 2056, 257, 2, True),
}


@pytest.mark.parametrize("case", list(THREE_LAUNCH))
def test_fused_plan_takes_three_launches_where_no_cluster_covers(case):
    """A unit past 16 blocks' shared memory, C/G off the 16-byte chunks,
    x off a 16-byte boundary, or more 16-byte slots a pixel than a block
    has threads: the three-launch path, which takes any shape."""
    n, c, groups, itemsize, aligned = THREE_LAUNCH[case]
    assert fused_plan(n, c, groups, itemsize, aligned) == (
        "three_launch", 0, 0, 0, 0)


@pytest.mark.parametrize("c,groups,itemsize,slab", [
    (128, 2, 2, 32), (64, 4, 4, 16), (16, 1, 2, 16), (40, 1, 4, 8),
    (48, 2, 2, 8), (24, 1, 2, 8), (12, 1, 4, 4), (40, 2, 4, 4)])
def test_fused_plan_slab_follows_the_group_width(c, groups, itemsize, slab):
    """A slab is 64 bytes of channels where C/G is a multiple of 64 bytes,
    else 32, else 16 (C/G not a multiple of the 64-byte slab's channels),
    on the cluster path."""
    plan = fused_plan(1000, c, groups, itemsize)
    assert (plan.path, plan.slab) == ("cluster", slab)


def _cluster_cover(b, n, c, groups, itemsize):
    """How often the cluster kernel (csrc/in_fused.cu) touches each
    element of x (B, N, C), modelled block by block and thread by thread:
    blockIdx = unit * cluster + rank, unit = sample * slabs + slab; block
    `rank` takes pixels [rank * rows, (rank + 1) * rows); thread t takes
    slot t % S of every P-th pixel from rank * rows + t // S and keeps its
    i-th chunk in a register below REG_CHUNKS, else at
    held[(i - REG_CHUNKS) * THREADS + t]. Also returns the largest `held`
    index used, in 16-byte chunks (-1: none)."""
    plan = fused_plan(n, c, groups, itemsize)
    assert plan.path == "cluster"
    v = 16 // itemsize
    cg = c // groups
    slabs, hs = cg // plan.slab, plan.slab // v
    slots = groups * hs
    lanes = FUSED_THREADS // slots
    cover = np.zeros((b, n, c), np.int64)
    top = -1
    for block in range(b * slabs * plan.cluster):
        unit, rank = divmod(block, plan.cluster)
        sample, j = divmod(unit, slabs)
        pend = min(n, (rank + 1) * plan.rows_per_block)
        for t in range(FUSED_THREADS):
            s, pl = t % slots, t // slots
            g, h = divmod(s, hs)
            p0 = rank * plan.rows_per_block + pl
            if pl >= lanes or p0 >= pend:
                continue
            m = -(-(pend - p0) // lanes)
            ch = g * cg + j * plan.slab + h * v
            cover[sample, p0:pend:lanes, ch:ch + v] += 1
            if m > REG_CHUNKS:
                top = max(top, (m - 1 - REG_CHUNKS) * FUSED_THREADS + t)
    return plan, cover, top


@pytest.mark.parametrize("shape", [
    (2, 64, 64, 1, 4), (2, 1024, 256, 4, 2), (1, 1000, 48, 2, 2),
    (1, 256, 96, 3, 4), (3, 561, 128, 2, 2), (2, 4096, 16, 1, 2),
    (1, 16384, 64, 1, 2), (1, 4096, 128, 4, 4), (2, 9075, 48, 2, 2),
    (1, 2304, 256, 4, 4)],
    ids=["g1_f32", "g4_bf16", "ragged", "g3", "odd_n", "whole_rows",
         "past_registers", "past_registers_g4", "ragged_blocks",
         "blocks_g4"])
def test_cluster_map_covers_every_element_once(shape):
    """Every (sample, channel, pixel) is in exactly one block's part and
    one thread's chunks, and each block's chunks past the registers fit
    its shared memory."""
    b, n, c, groups, itemsize = shape
    plan, cover, top = _cluster_cover(b, n, c, groups, itemsize)
    assert (cover == 1).all()
    assert (top + 1) * 16 <= plan.smem_bytes


@pytest.mark.parametrize("path", [None, *FUSED_PATHS])
@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_fused_launcher_takes_only_cuda_tensors(device, path):
    """K8's launcher (its launches) refuses a tensor off CUDA on either
    path; only the wrapper sends CPU tensors to the plain version."""
    x = torch.empty(2, 4, 4, 16, device=device)
    cuda_build.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_launcher(x, relu=True, phase_groups=2, path=path)
    assert set(cuda_build.LAUNCHES.values()) == {0}
