"""The LM kernels' routes and the tensor-core attention's arithmetic, on
the CPU.

``ops.route`` (``repro_torch.kernels.wavefront_matmul`` and
``.flash_attention``) picks the hand-written kernel a CUDA tensor goes to
by an explicit rule over type, shape, layout and alignment; here it is
held at the granite serve's shapes and at the edges of each rule.  The
rule is a pure function of the operands, so CPU tensors stand in for CUDA
ones (the wrappers themselves take the plain versions on the CPU).

The ``wgmma`` attention rounds P to bfloat16 as a hi + lo pair for the
P V product; :func:`hilo_attention` models that kernel's arithmetic in
plain torch (64-key tiles, online softmax, two bf16 products into one
float32 sum) and is held within ``ops.TOLERANCE[bfloat16]`` of
``mha_ref``.  The ``wgmma`` backward rounds both P and dS so;
:func:`hilo_attention_bwd` models its two kernels and is held within
``ops.BWD_TOLERANCE[bfloat16]`` of ``mha_ref_bwd``, where one bf16 P or
dS is not.  No JAX is needed: ``mha_ref`` is tied to the reference by
``tests/test_torch_lm_kernels.py``.  The kernels themselves run on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as fops, ref as fref  # noqa: E402
from repro_torch.kernels.wavefront_matmul import ops as mops  # noqa: E402

BF, F32 = torch.bfloat16, torch.float32


@pytest.fixture(autouse=True)
def pinned():
    """The process-wide torch state the models' arithmetic below depends
    on, pinned for each test and restored after it (a test file that ran
    before in the same worker may have left it otherwise): one intra-op
    thread, float32 as the default type, the highest float32 matmul
    precision.  Returns the state found, for the failure messages."""
    found = {"threads": torch.get_num_threads(),
             "default_dtype": torch.get_default_dtype(),
             "matmul_precision": torch.get_float32_matmul_precision()}
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float32)
    torch.set_float32_matmul_precision("highest")
    yield found
    torch.set_num_threads(found["threads"])
    torch.set_default_dtype(found["default_dtype"])
    torch.set_float32_matmul_precision(found["matmul_precision"])


def _z(*shape, dtype=BF):
    return torch.zeros(shape, dtype=dtype)


def _misaligned(*shape, dtype=BF):
    """A contiguous tensor whose base is 2 bytes past a 16-byte line."""
    n = int(np.prod(shape))
    return torch.zeros(n + 8, dtype=dtype)[1:n + 1].view(shape)


# --- wavefront_matmul.route -------------------------------------------------

@pytest.mark.parametrize("a,b,want", [
    # the granite serve's expert GEMMs: prefill (capacity 819) up and down,
    # decode (capacity 2) up and down
    ((40, 819, 1536), (40, 1536, 512), "wgmma"),
    ((40, 819, 512), (40, 512, 1536), "wgmma"),
    ((40, 2, 1536), (40, 1536, 512), "small_m"),
    ((40, 2, 512), (40, 512, 1536), "small_m"),
    # the small-M limit and one row above it
    ((3, 1, 64), (3, 64, 32), "small_m"),
    ((3, 16, 64), (3, 64, 32), "small_m"),
    ((3, 17, 64), (3, 64, 32), "wgmma"),
    # 2-D operands, ragged K that TMA can still read (K % 8 == 0)
    ((819, 48), (48, 96), "wgmma"),
    ((819, 160), (160, 96), "wgmma"),
    # rows TMA cannot read: K or N * 2 bytes not a multiple of 16
    ((5, 200, 100), (5, 100, 64), "simt"),
    ((5, 200, 64), (5, 64, 36), "simt"),
    ((5, 2, 100), (5, 100, 64), "simt"),
])
def test_gemm_route_bf16(a, b, want):
    assert mops.route(_z(*a), _z(*b)) == want


@pytest.mark.parametrize("m,want", [(1, "small_m"), (2, "small_m"),
                                    (16, "small_m"), (17, "simt"),
                                    (819, "simt")])
def test_gemm_route_float32(m, want):
    """float32 goes to small_m or the CUDA cores, never to TF32 wgmma."""
    assert mops.route(_z(40, m, 1536, dtype=F32),
                      _z(40, 1536, 512, dtype=F32)) == want


@pytest.mark.parametrize("which", ["a", "b"])
@pytest.mark.parametrize("m", [2, 819])
def test_gemm_route_misaligned_base_is_simt(which, m):
    a = _misaligned(4, m, 64) if which == "a" else _z(4, m, 64)
    b = _misaligned(4, 64, 128) if which == "b" else _z(4, 64, 128)
    assert mops.route(a, b) == "simt"


def test_gemm_route_non_contiguous_is_simt():
    a = _z(4, 64, 819).transpose(1, 2)
    assert not a.is_contiguous()
    assert mops.route(a, _z(4, 64, 128)) == "simt"
    assert mops.route(a.contiguous(), _z(4, 64, 128)) == "wgmma"


@pytest.mark.parametrize("dtype,k,want", [(BF, 1536, "small_m"),
                                          (BF, 8192, "wgmma"),
                                          (F32, 8192, "simt")])
def test_gemm_route_small_m_shared_memory_limit(dtype, k, want):
    """16 rows of A must fit shared memory beside the copy ring."""
    fits = mops.small_m_smem(16, k, torch.tensor([], dtype=dtype)
                             .element_size()) <= mops.SMEM_LIMIT
    assert fits == (want == "small_m")
    assert mops.route(_z(2, 16, k, dtype=dtype),
                      _z(2, k, 64, dtype=dtype)) == want


@pytest.mark.parametrize("m,mt", [(1, 1), (2, 2), (3, 4), (5, 8), (9, 16),
                                  (16, 16)])
def test_small_m_rounds_rows_to_a_power_of_two(m, mt):
    assert mops.small_m_smem(m, 64, 2) == (mt * 64 * 2 + 8 * 256 * 16
                                           + 8 * 64 * 4 * mt)


def test_cpu_call_counts_no_route():
    before = dict(mops.wavefront_matmul.by_route)
    a, b = torch.ones(2, 819, 64, dtype=BF), torch.ones(2, 64, 32, dtype=BF)
    out = mops.wavefront_matmul(a, b, torch.ones(2, 7, dtype=torch.int32))
    assert out.dtype == BF and float(out[0, 0, 0]) == 64.0
    assert mops.wavefront_matmul.by_route == before
    assert set(before) == set(mops.ROUTES)


# --- flash_attention.route --------------------------------------------------

@pytest.mark.parametrize("q,kv,dtype,want", [
    # the granite serve: prefill, causal over its own 512 positions, and
    # decode, one position of 24 heads over a 1,024 cache
    ((8, 24, 512, 64), (8, 8, 512, 64), BF, "wgmma"),
    ((8, 24, 1, 64), (8, 8, 1024, 64), BF, "split"),
    ((8, 24, 1, 64), (8, 8, 1024, 64), F32, "split"),
    ((8, 24, 1, 64), (8, 8, 129, 64), BF, "split"),       # 3 tiles
    ((8, 24, 1, 64), (8, 8, 128, 64), BF, "simt"),        # 2 tiles
    ((2, 4, 1, 12), (2, 4, 300, 12), BF, "split"),
    # the reference tests' and the ragged cases
    ((2, 4, 100, 128), (2, 2, 300, 128), BF, "wgmma"),
    ((2, 2, 128, 64), (2, 2, 256, 64), BF, "wgmma"),
    ((2, 6, 37, 12), (2, 2, 37, 12), BF, "simt"),        # head_dim 12
    ((2, 4, 16, 16), (2, 4, 48, 16), BF, "simt"),        # 16 rows: decode's
    ((2, 4, 16, 16), (2, 4, 200, 16), BF, "split"),
    ((2, 4, 17, 16), (2, 4, 48, 16), BF, "wgmma"),
    ((2, 2, 64, 160), (2, 2, 64, 160), BF, "simt"),      # above 128
    ((2, 2, 64, 40), (2, 2, 64, 40), BF, "simt"),        # not a multiple of 16
    ((8, 24, 512, 64), (8, 8, 512, 64), F32, "simt"),
])
def test_attention_route(q, kv, dtype, want):
    assert fops.route(_z(*q, dtype=dtype), _z(*kv, dtype=dtype),
                      _z(*kv, dtype=dtype)) == want


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_attention_route_misaligned_base_is_simt(which):
    shapes = {"q": (2, 4, 128, 64), "k": (2, 2, 128, 64), "v": (2, 2, 128, 64)}
    t = {n: (_misaligned(*s) if n == which else _z(*s))
         for n, s in shapes.items()}
    assert fops.route(t["q"], t["k"], t["v"]) == "simt"


# --- the wgmma attention's arithmetic ----------------------------------------

def hilo_attention(q, k, v, lengths, causal, tile=64, split=True):
    """The ``wgmma`` kernel's arithmetic in plain torch: per 64-key tile,
    float32 scores of the bf16 inputs, masked, scaled, an online softmax
    in float32, and ``P V`` from P rounded to bf16 as hi + lo (``split``)
    or once; bf16 output."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    qf = q.float()
    kf = k.float().repeat_interleave(g, 1)
    vf = v.float().repeat_interleave(g, 1)
    scale = 1.0 / math.sqrt(d)
    m = torch.full((b, h, sq, 1), -1e30, dtype=F32)
    l = torch.zeros((b, h, sq, 1), dtype=F32)
    acc = torch.zeros((b, h, sq, d), dtype=F32)
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, sk, tile):
        keys = torch.arange(k0, min(k0 + tile, sk))
        s = qf @ kf[:, :, keys].transpose(-1, -2)
        live = keys[None, :] < lengths[:, None, None, None]
        if causal:
            live = live & (keys[None, :] <= qpos + (sk - sq))
        s = torch.where(live, s * scale, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(live, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
        hi = p.bfloat16().float()
        pv = hi @ vf[:, :, keys]
        if split:
            pv = pv + (p - hi).bfloat16().float() @ vf[:, :, keys]
        acc = acc * alpha + pv
    return (acc / l.clamp(min=1e-30)).bfloat16()


def _qkv(seed, b, h, kv, sq, sk, d):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s)
                                     .astype(np.float32)).bfloat16()
    lens = torch.from_numpy(rng.integers(1, sk + 1, b).astype(np.int32))
    lens[0] = sk
    return mk(b, h, sq, d), mk(b, kv, sk, d), mk(b, kv, sk, d), lens


def _off(got, exp):
    atol, rtol = fops.TOLERANCE[BF]
    g, e = got.float(), exp.float()
    return int(((g - e).abs() > atol + rtol * e.abs()).sum())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("b,h,kv,sq,sk,d,causal", [
    (2, 3, 1, 128, 128, 64, True), (2, 6, 2, 96, 200, 64, True),
    (2, 4, 2, 100, 300, 128, True), (2, 2, 2, 128, 256, 32, False)])
def test_hilo_pv_within_bf16_tolerance(seed, b, h, kv, sq, sk, d, causal,
                                      pinned):
    q, k, v, lens = _qkv(seed, b, h, kv, sq, sk, d)
    exp = fref.mha_ref(q, k, v, lens, causal).to(BF)
    got = hilo_attention(q, k, v, lens, causal)
    err = lambda x: float((x.float() - exp.float()).abs().max())
    assert _off(got, exp) == 0, (err(got), pinned)
    # one bf16 P is visibly coarser than the pair
    one = hilo_attention(q, k, v, lens, causal, split=False)
    assert err(one) >= err(got), (err(one), err(got), pinned)


@pytest.mark.parametrize("causal", [True, False])
def test_hilo_masked_keys_change_no_bit(causal):
    """A masked key has P = 0 exactly, its P_lo too: poisoned keys and
    values past each length leave every output bit as it was."""
    q, k, v, lens = _qkv(5, 3, 6, 2, 80, 160, 64)
    lens = torch.tensor([160, 70, 1], dtype=torch.int32)
    got = hilo_attention(q, k, v, lens, causal)
    k2, v2 = k.clone(), v.clone()
    for i, n in enumerate(lens.tolist()):
        k2[i, :, n:] = 1e4
        v2[i, :, n:] = -1e4
    assert torch.equal(hilo_attention(q, k2, v2, lens, causal), got)


# --- flash_attention.route_bwd ----------------------------------------------

@pytest.mark.parametrize("q,kv,dtype,want", [
    # the granite training call (S 511: the loss drops the last token)
    ((8, 24, 511, 64), (8, 8, 511, 64), BF, "wgmma"),
    ((8, 24, 511, 64), (8, 8, 511, 64), F32, "simt"),
    # head_dim: 16 and 128 are taken, 12, 40 and 160 not
    ((2, 4, 100, 128), (2, 1, 300, 128), BF, "wgmma"),
    ((2, 4, 16, 16), (2, 4, 48, 16), BF, "wgmma"),
    ((2, 6, 37, 12), (2, 2, 37, 12), BF, "simt"),
    ((2, 2, 64, 40), (2, 2, 64, 40), BF, "simt"),
    ((2, 2, 64, 160), (2, 2, 64, 160), BF, "simt"),
    # decode's one row: the backward has no decode route
    ((3, 24, 1, 64), (3, 8, 1024, 64), BF, "wgmma"),
])
def test_attention_route_bwd(q, kv, dtype, want):
    qq, oo, do = (_z(*q, dtype=dtype) for _ in range(3))
    assert fops.route_bwd(qq, _z(*kv, dtype=dtype), _z(*kv, dtype=dtype),
                          oo, do) == want


@pytest.mark.parametrize("which", ["q", "k", "v", "o", "do"])
def test_attention_route_bwd_misaligned_base_is_simt(which):
    shapes = {"q": (2, 4, 128, 64), "k": (2, 2, 128, 64),
              "v": (2, 2, 128, 64), "o": (2, 4, 128, 64),
              "do": (2, 4, 128, 64)}
    t = {n: (_misaligned(*s) if n == which else _z(*s))
         for n, s in shapes.items()}
    assert fops.route_bwd(*t.values()) == "simt"


@pytest.mark.parametrize("which", ["q", "do"])
def test_attention_route_bwd_non_contiguous_is_simt(which):
    """A transposed operand is not TMA-legal as it is (``attention_bwd``
    makes it contiguous first, and then takes ``wgmma``)."""
    t = {n: _z(2, 4, 128, 64) for n in ("q", "o", "do")}
    t[which] = _z(2, 4, 64, 128).transpose(2, 3)
    assert not t[which].is_contiguous()
    k, v = _z(2, 2, 128, 64), _z(2, 2, 128, 64)
    assert fops.route_bwd(t["q"], k, v, t["o"], t["do"]) == "simt"
    t[which] = t[which].contiguous()
    assert fops.route_bwd(t["q"], k, v, t["o"], t["do"]) == "wgmma"


def test_attention_route_bwd_mixed_types_is_simt():
    """o or do in another type than bfloat16 goes to ``simt``."""
    q, k, v = _z(2, 4, 128, 64), _z(2, 2, 128, 64), _z(2, 2, 128, 64)
    assert fops.route_bwd(q, k, v, q, _z(2, 4, 128, 64, dtype=F32)) == "simt"
    assert fops.route_bwd(q, k, v, _z(2, 4, 128, 64, dtype=F32), q) == "simt"


def test_cpu_backward_counts_no_route():
    """On the CPU ``attention_bwd`` is the plain version: no launch is
    counted, and the counters are by kernel and route."""
    before = {k: dict(r) for k, r in
              fops.flash_attention.backward_by_route.items()}
    q, k, v, lens = _qkv(2, 1, 2, 1, 64, 64, 64)
    o = fref.mha_ref(q, k, v, lens, True).to(BF)
    got = fops.attention_bwd(q, k, v, o, q, lens, True)
    assert [x.dtype for x in got] == [BF] * 3
    assert fops.flash_attention.backward_by_route == before
    assert set(before) == set(fops.BWD_KERNELS)
    assert all(set(r) == set(fops.BWD_ROUTES) for r in before.values())


# --- the wgmma backward's arithmetic -----------------------------------------

def _hilo(x, split):
    """x as the bf16 parts the kernel feeds a product: hi, and lo."""
    hi = x.bfloat16().float()
    return (hi, (x - hi).bfloat16().float()) if split else (hi,)


def hilo_attention_bwd(q, k, v, o, do, lengths, causal, split_p=True,
                       split_ds=True):
    """The ``wgmma`` backward's arithmetic in plain torch, (dq, dk, dv) in
    bf16.  The dq kernel: the row statistics over 64-key tiles in log2
    units (online max and sum), Delta = rowsum(do * o), then per 64-key
    tile P = 2^(S scale log2 e - lse2), dS = P (dP - Delta), and
    ``dQ += dS K`` from dS rounded to bf16 as hi + lo (``split_ds``) or
    once.  The dkdv kernel: per 64-key tile, the G heads of its KV head in
    order, each in 32-query steps, ``dV += P^T dO`` and
    ``dK += dS^T Q`` from P (``split_p``) and dS so rounded.  Scores of
    the bf16 inputs in float32; masked pairs zero."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(g, 1)
    vf = v.float().repeat_interleave(g, 1)
    scale = 1.0 / math.sqrt(d)
    scale2 = scale * math.log2(math.e)
    qpos = torch.arange(sq)[:, None]
    tiles = [torch.arange(k0, min(k0 + 64, sk)) for k0 in range(0, sk, 64)]

    def live(keys):
        lv = keys[None, :] < lengths[:, None, None, None]
        if causal:
            lv = lv & (keys[None, :] <= qpos + (sk - sq))
        return lv

    m = torch.full((b, h, sq, 1), -1e30, dtype=F32)
    l = torch.zeros((b, h, sq, 1), dtype=F32)
    for keys in tiles:
        lv = live(keys)
        s = torch.where(lv, qf @ kf[:, :, keys].transpose(-1, -2) * scale2,
                        -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(lv, torch.exp2(s - m_new), 0.0)
        l = l * torch.exp2(m - m_new) + p.sum(-1, keepdim=True)
        m = m_new
    lse2 = torch.where(l > 0, m + torch.log2(l), 0.0)
    delta = (dof * o.float()).sum(-1, keepdim=True)

    dq = torch.zeros((b, h, sq, d), dtype=F32)
    dk = torch.zeros((b, kv, sk, d), dtype=F32)
    dv = torch.zeros((b, kv, sk, d), dtype=F32)
    for keys in tiles:
        lv = live(keys)
        s = qf @ kf[:, :, keys].transpose(-1, -2)
        p = torch.where(lv, torch.exp2(s * scale2 - lse2), 0.0)
        dp = dof @ vf[:, :, keys].transpose(-1, -2)
        ds = torch.where(lv, p * (dp - delta), 0.0)
        for part in _hilo(ds, split_ds):
            dq += part @ kf[:, :, keys]
        # dkdv: (b, KV, G, ...) so that the G heads go in order
        p5, ds5 = (x.reshape(b, kv, g, sq, -1) for x in (p, ds))
        q5, do5 = qf.reshape(b, kv, g, sq, d), dof.reshape(b, kv, g, sq, d)
        for hh in range(g):
            for q0 in range(0, sq, 32):
                rows = slice(q0, q0 + 32)
                for part in _hilo(p5[:, :, hh, rows], split_p):
                    dv[:, :, keys] += part.transpose(-1, -2) \
                        @ do5[:, :, hh, rows]
                for part in _hilo(ds5[:, :, hh, rows], split_ds):
                    dk[:, :, keys] += part.transpose(-1, -2) \
                        @ q5[:, :, hh, rows]
    return ((dq * scale).bfloat16(), (dk * scale).bfloat16(),
            dv.bfloat16())


def _bwd_inputs(seed, b, h, kv, sq, sk, d, causal, lengths=None):
    """q, k, v, do from seeded numpy, lengths (random, the first full, or
    given) and the forward's output o, rounded to bf16 as the kernel
    saves it."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s)
                                     .astype(np.float32)).bfloat16()
    q, k, v, do = mk(b, h, sq, d), mk(b, kv, sk, d), mk(b, kv, sk, d), \
        mk(b, h, sq, d)
    if lengths is None:
        lens = torch.from_numpy(rng.integers(1, sk + 1, b).astype(np.int32))
        lens[0] = sk
    else:
        lens = torch.tensor(lengths, dtype=torch.int32)
    o = fref.mha_ref(q, k, v, lens, causal).to(BF)
    return q, k, v, o, do, lens


def _off_bwd(got, exp):
    """Elements of (dq, dk, dv) beyond ``BWD_TOLERANCE[bfloat16]``."""
    atol, rtol = fops.BWD_TOLERANCE[BF]
    return [int(((g.float() - e.float()).abs()
                 > atol + rtol * e.float().abs()).sum())
            for g, e in zip(got, exp)]


#: (B, H, KV, Sq, Sk, D, causal, lengths): GQA G = 1, 3, 4; ragged S; a
#: length of 0; causal with Sq > Sk (the first rows see no key); Sk > Sq
BWD_MODEL_CASES = [(2, 2, 2, 128, 128, 64, True, None),
                   (2, 6, 2, 96, 200, 64, True, None),
                   (2, 4, 1, 100, 300, 128, True, None),
                   (2, 6, 2, 75, 75, 32, False, None),
                   (3, 6, 2, 70, 70, 64, True, (70, 0, 33)),
                   (2, 4, 1, 150, 90, 64, True, (90, 57)),
                   (2, 4, 4, 16, 48, 16, False, (48, 0))]


@pytest.mark.parametrize("b,h,kv,sq,sk,d,causal,lengths", BWD_MODEL_CASES)
def test_hilo_bwd_within_bf16_tolerance(b, h, kv, sq, sk, d, causal,
                                        lengths):
    q, k, v, o, do, lens = _bwd_inputs(sq + sk + d, b, h, kv, sq, sk, d,
                                       causal, lengths)
    exp = fref.mha_ref_bwd(q, k, v, o, do, lens, causal)
    got = hilo_attention_bwd(q, k, v, o, do, lens, causal)
    assert _off_bwd(got, exp) == [0, 0, 0]
    # rows with no live key: zero dq, and a length-0 entry's keys zero dk
    for i, n in enumerate(lens.tolist()):
        dead = sq if n == 0 else (max(0, sq - sk) if causal else 0)
        assert not torch.count_nonzero(got[0][i, :, :dead])
        assert not torch.count_nonzero(got[1][i, :, n:])
        assert not torch.count_nonzero(got[2][i, :, n:])


@pytest.mark.parametrize("seed", [0, 1])
def test_hilo_bwd_one_bf16_p_or_ds_misses_tolerance(seed):
    """Why the kernels take P and dS as hi + lo pairs: one bf16 P puts dv
    beyond ``BWD_TOLERANCE[bfloat16]``, one bf16 dS dq and dk."""
    case = (2, 6, 2, 96, 200, 64, True)
    q, k, v, o, do, lens = _bwd_inputs(seed, *case)
    exp = fref.mha_ref_bwd(q, k, v, o, do, lens, True)
    one_p = _off_bwd(hilo_attention_bwd(q, k, v, o, do, lens, True,
                                        split_p=False), exp)
    one_ds = _off_bwd(hilo_attention_bwd(q, k, v, o, do, lens, True,
                                         split_ds=False), exp)
    assert one_p[:2] == [0, 0] and one_p[2] > 0
    assert one_ds[0] > 0 and one_ds[1] > 0 and one_ds[2] == 0


@pytest.mark.parametrize("causal", [True, False])
def test_hilo_bwd_poisoned_keys_change_no_bit_of_dq(causal):
    """Keys past each length hold 1e4 and values -1e4: P and dS are
    exactly zero there, so dq keeps every bit and those keys' dk, dv are
    zero."""
    q, k, v, o, do, lens = _bwd_inputs(7, 3, 6, 2, 80, 160, 64, causal,
                                       (160, 70, 1))
    got = hilo_attention_bwd(q, k, v, o, do, lens, causal)
    k2, v2 = k.clone(), v.clone()
    for i, n in enumerate(lens.tolist()):
        k2[i, :, n:] = 1e4
        v2[i, :, n:] = -1e4
    p = hilo_attention_bwd(q, k2, v2, o, do, lens, causal)
    assert torch.equal(p[0], got[0])
    for i, n in enumerate(lens.tolist()):
        assert not torch.count_nonzero(p[1][i, :, n:])
        assert not torch.count_nonzero(p[2][i, :, n:])
