"""K3: fused fully quantized convolution (implicit GEMM), NHWC int8, and
K3b: the same conv with the fused max-pool epilogue.

Counterpart of ``repro.kernels.fq_conv`` (Pallas). Layout contract, as in
the reference and the im2col path:

  * activations  (B, H, W, Cin) int8 codes, NHWC,
  * weights      (kh*kw*Cin, Cout) int8 codes, tap-major (row t*Cin + c is
                 tap (t // kw, t % kw), channel c); packed (``weight_format``
                 "int4" or "ternary", K5): (kh*kw*cin_p/factor, Cout) uint8,
                 cin padded per tap to cin_p, a multiple of the factor
                 (``core.quant.pack_im2col_codes``),
  * output       (B, Ho, Wo, Cout) int8 codes (requant) or f32 (dequant);
                 (B, Ho // ph, Wo // pw, Cout) with ``pool=(ph, pw)``.

For a CUDA tensor the wrapper launches ``csrc/fq_conv.cu``, which gathers
each window in place with zero padding by bounds check; for a CPU tensor it
runs the plain version, :func:`fq_conv2d_plain`. K3 and K3b run on the
tensor cores; their A operand takes the
loader :func:`a_loader` picks per launch, and ``vector_launches`` (on
:func:`fq_conv2d` and on :func:`fq_conv2d_pool`) counts the launches that
took the vector one. With packed weights the kernel reduces over taps x
cin_p and decodes the bytes in its tile loop; the activations are not
padded. ``launches`` counts every launch, ``packed_launches[fmt]`` the
packed ones.

ADC noise (K4), as in K2: the field at the conv output's global index
((b * Ho + h) * Wo + w) * Cout + c goes onto f32(acc) before the pool and
the epilogue; with ``pool=`` the max runs on the noisy float32
accumulator, each window position with the field of its unpooled index.
``noisy_launches`` counts those launches.

The tile policy, :func:`pick_blocks`, is the reference's under its names:
explicit knobs win, then the measured table (``autotune_table.json``
beside this file, the port's own, stamped backend ``cuda`` and written on
the card by ``python -m repro_torch.kernels.autotune --record``), then a
fallback of the H100's. Misses of the table are counted and warned as the
reference counts them, attributed to the active :func:`replica_scope`. It
runs on every CUDA launch of :func:`fq_conv2d` (under a CUDA graph: once,
at capture). The kernel reads only its ``bc``, the block of input
channels: a ``bc`` below Cin on an unpooled int8 conv runs the reduction
as Cin / bc splits (split-K, counted in ``fq_conv2d.split_launches``),
reduced in int32 inside a thread-block cluster before the epilogue, in the
same launch, so the codes do not change. ``bho`` and ``bco`` are validated
and returned as the reference returns them; the 64 x 64 wgmma tile does
not read them (as K1's kernel does not read the reference's
``block_rows``). On the CPU
the plain version runs unsplit and explicit knobs are only validated.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import os
import warnings
from typing import Dict, Optional, Tuple

import torch

from ..core.quant import WEIGHT_FORMATS, format_factor
from . import _build
from .fq_matmul import (VECTOR_BYTES, b_vector, check_noise, check_operands,
                        noise_pointers, packed_counts)
from .ref import ref_fq_conv2d as fq_conv2d_plain

_CONV_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 15
_SIG = {"fq_conv2d_s8": _CONV_ARGS + [ctypes.c_int] * 7 + [ctypes.c_void_p],
        "fq_conv2d_pool_s8": _CONV_ARGS + [ctypes.c_int] * 9
        + [ctypes.c_void_p],
        "fq_conv2d_splitk_s8": _CONV_ARGS + [ctypes.c_int] * 8
        + [ctypes.c_void_p]}

# ---------------------------------------------------------------------------
# The tile policy (counterpart of the reference's block-size selection)
# ---------------------------------------------------------------------------

# The reference's hand defaults, keyed by (kh, kw, stride_h, weight_format);
# measured entries of the table override them. A packed lookup that misses
# borrows the same-shape int8 entry (minus bc, which packed kernels fix).
_BUILTIN_TABLE: dict = {
    (3, 3, 1, "int8"): {"bco": 128},
    (3, 3, 2, "int8"): {"bco": 128},
    (1, 1, 1, "int8"): {"bho": 128, "bco": 128},
}

AUTOTUNE_TABLE_PATH = os.path.join(os.path.dirname(__file__),
                                   "autotune_table.json")
AUTOTUNE_SCRIPT = "python -m repro_torch.kernels.autotune --record"

# The CUDA tile loop (csrc/igemm_tc.cuh): a 64 x 64 output tile a block in
# stages of 64 codes; a ring of 6 A and raw B stages and 3 transposed B
# stages in dynamic shared memory.
TILE_M = TILE_N = TILE_K = 64
_RING, _BT_RING = 6, 3
SMEM_BUDGET = 232_448       # dynamic shared memory a block may use (H100)
H100_SMS = 132
SPLIT_MIN_STAGES = 8        # tile-loop stages each split keeps at least
SPLIT_MAX_WAVES = 2         # blocks of a split conv: at most 2 x the SMs


class AutotuneMissWarning(UserWarning):
    """A conv shape has no measured autotune entry for the backend: its
    blocks come from the builtin defaults and the fallback. ``.key`` is the
    (kh, kw, stride, weight_format) lookup key, ``.backend`` the backend it
    was missing for."""

    def __init__(self, key: Tuple[int, int, int, str], backend: str):
        self.key = key
        self.backend = backend
        super().__init__(
            f"no measured autotune entry for conv shape key {key} on "
            f"backend {backend!r}; falling back to builtin defaults "
            f"(run {AUTOTUNE_SCRIPT} to measure it)")


def _table_doc(path: Optional[str], backend: str):
    """The table's JSON document when it is one of ``backend``'s, else
    None (a missing, corrupt or foreign file)."""
    try:
        with open(path or AUTOTUNE_TABLE_PATH) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("format") != 1 \
            or doc.get("backend") != backend:
        return None
    return doc


def load_autotune_table(path: Optional[str] = None, *,
                        backend: str = "cuda") -> dict:
    """Builtin defaults overlaid with the measured entries of ``backend``
    (``path``: the table beside this module). A table from another backend
    is ignored; malformed entries and unknown weight formats are skipped."""
    table = {k: dict(v) for k, v in _BUILTIN_TABLE.items()}
    doc = _table_doc(path, backend)
    for e in (doc or {}).get("entries", []):
        try:
            fmt = str(e.get("format", "int8"))
            key = (int(e["kh"]), int(e["kw"]), int(e["stride"]), fmt)
            knobs = {k: int(e[k]) for k in ("bho", "bco", "bc") if e.get(k)}
        except (KeyError, TypeError, ValueError, AttributeError):
            continue  # a malformed entry never takes the defaults down
        if fmt not in WEIGHT_FORMATS:
            continue
        table[key] = knobs
    return table


def measured_keys(path: Optional[str] = None, *,
                  backend: str = "cuda") -> set:
    """Lookup keys with a measured entry for ``backend``."""
    keys = set()
    doc = _table_doc(path, backend)
    for e in (doc or {}).get("entries", []):
        try:
            keys.add((int(e["kh"]), int(e["kw"]), int(e["stride"]),
                      str(e.get("format", "int8"))))
        except (KeyError, TypeError, ValueError, AttributeError):
            continue
    return keys


# Memoized per backend on first use. AUTOTUNE_MISSES counts, per
# (kh, kw, stride, weight_format), the pick_blocks calls that missed a
# measured entry; AUTOTUNE_MISSES_BY_REPLICA the same per (replica tag,
# key) inside a replica_scope. A CUDA graph runs the policy once, at
# capture, so its misses count once per capture (the reference's: once
# per trace).
_TABLES: Dict[str, dict] = {}
_MEASURED: Dict[str, set] = {}
AUTOTUNE_MISSES: dict = {}
AUTOTUNE_MISSES_BY_REPLICA: dict = {}
_REPLICA_TAG: list = [None]
_WARNED_KEYS: set = set()


@contextlib.contextmanager
def replica_scope(tag):
    """Attribute autotune-table misses inside the block to replica ``tag``
    (``serve.cnn_batching`` opens one around each lane's step)."""
    prev, _REPLICA_TAG[0] = _REPLICA_TAG[0], tag
    try:
        yield
    finally:
        _REPLICA_TAG[0] = prev


def _autotune_table(backend: str) -> dict:
    if backend not in _TABLES:
        _TABLES[backend] = load_autotune_table(backend=backend)
        _MEASURED[backend] = measured_keys(backend=backend)
    return _TABLES[backend]


def reset_autotune_cache():
    """Drop the memoized tables and the warn / miss state (tests, table
    swaps)."""
    _TABLES.clear()
    _MEASURED.clear()
    AUTOTUNE_MISSES.clear()
    AUTOTUNE_MISSES_BY_REPLICA.clear()
    _WARNED_KEYS.clear()


def _note_autotune_miss(key: Tuple[int, int, int, str], backend: str):
    AUTOTUNE_MISSES[key] = AUTOTUNE_MISSES.get(key, 0) + 1
    if _REPLICA_TAG[0] is not None:
        rk = (_REPLICA_TAG[0], key)
        AUTOTUNE_MISSES_BY_REPLICA[rk] = \
            AUTOTUNE_MISSES_BY_REPLICA.get(rk, 0) + 1
    if key not in _WARNED_KEYS:
        _WARNED_KEYS.add(key)
        warnings.warn(AutotuneMissWarning(key, backend), stacklevel=3)


def smem_footprint() -> int:
    """Dynamic shared memory of one K3 / K3b block (csrc/igemm_tc.cuh):
    the 6-stage A and raw B rings and the 3-stage transposed B ring of
    64 x 64-byte tiles, 61,440 bytes whatever the conv (packed B stages
    are decoded into the same tiles). The counterpart of the reference's
    ``vmem_footprint``; :data:`SMEM_BUDGET` is what a block may use."""
    return (2 * _RING + _BT_RING) * TILE_M * TILE_K


def _divisor_at_most(n: int, cap: int) -> int:
    for d in range(min(n, cap), 0, -1):
        if n % d == 0:
            return d
    return 1


def split_fallback(*, m: int, cin: int, cout: int, kh: int, kw: int,
                   sms: int = H100_SMS) -> int:
    """The H100 fallback's ``bc`` for an unpooled int8 conv whose output
    has ``m`` = B*Ho*Wo rows: Cin (no split) unless its 64 x 64 tiles are
    fewer than ``sms``; then the smallest divisor of Cin (a multiple of 16
    when Cin is, so the splits keep the vector loader) whose splits each
    keep SPLIT_MIN_STAGES stages of 64 codes and whose blocks stay within
    SPLIT_MAX_WAVES x ``sms``."""
    tiles = -(-m // TILE_M) * -(-cout // TILE_N)
    bc = cin
    if tiles >= sms:
        return bc
    for split in range(2, cin + 1):
        if cin % split:
            continue
        cand = cin // split
        if kh * kw * cand < SPLIT_MIN_STAGES * TILE_K \
                or tiles * split > SPLIT_MAX_WAVES * sms:
            break
        if cin % 16 == 0 and cand % 16:
            continue
        bc = cand
    return bc


def check_blocks(cin: int, bc: Optional[int],
                 weight_format: str) -> Optional[int]:
    """The reference's checks of an explicit ``bc``: it must divide cin
    (ValueError), and packed formats fix it to cin rounded up to the pack
    factor (ValueError on any other). Returns the bc to use: cin_p when
    packed, else ``bc`` (None when unset)."""
    if weight_format != "int8":
        factor = format_factor(weight_format)
        cin_p = -(-cin // factor) * factor
        if bc is not None and bc != cin_p:
            raise ValueError(
                f"weight_format={weight_format!r} requires bc == cin "
                f"padded to the pack factor ({cin_p}), got bc={bc}")
        return cin_p
    if bc is not None and (bc < 1 or cin % bc != 0):
        raise ValueError(f"bc={bc} must divide cin={cin}")
    return bc


def pick_blocks(*, ho: int, wo: int, cin: int, cout: int, kh: int, kw: int,
                stride: Tuple[int, int],
                pool: Optional[Tuple[int, int]] = None,
                bho: Optional[int] = None, bco: Optional[int] = None,
                bc: Optional[int] = None, weight_format: str = "int8",
                batch: int = 1, backend: str = "cuda",
                sms: int = H100_SMS) -> Tuple[int, int, int]:
    """(bho, bco, bc): output-row / output-channel / input-channel blocks,
    as the reference picks them (``repro.kernels.fq_conv.pick_blocks``).

    Explicit arguments win, then the table of ``backend``, then the
    fallback. An explicit ``bc`` must divide ``cin``; a table ``bc`` is
    rounded down to a divisor; packed formats fix ``bc`` to cin rounded up
    to the pack factor and raise on any other; a packed key that misses
    borrows the int8 entry's bho / bco. A lookup is a miss, counted and
    warned once per key, only when the table was consulted (not every knob
    explicit) and has no measured entry for the key. With ``pool``, bho is
    rounded down to a multiple of the pool height.

    What differs on the card: the fallback is the H100's. ``bco`` is
    min(128, cout) and ``bho`` min(ho, 128), the reference's starting
    points, which :func:`smem_footprint` does not grow with, so nothing
    shrinks. ``bc`` is :func:`split_fallback` for an unpooled int8 conv at
    request batch ``batch`` on ``sms`` SMs. A pooled conv is never split by
    the table or the fallback (K3b keeps one split; an explicit ``bc`` on
    one is validated, returned and not read).
    """
    packed = weight_format != "int8"
    bc = check_blocks(cin, bc, weight_format)
    key = (kh, kw, stride[0], weight_format)
    table = _autotune_table(backend)
    over = table.get(key)
    if over is None and packed:
        over = {k: v for k, v in table.get(
            (kh, kw, stride[0], "int8"), {}).items() if k != "bc"}
    over = over or {}
    explicit = bho is not None and bco is not None \
        and (packed or bc is not None)
    if not explicit and key not in _MEASURED[backend]:
        # only a real table consultation counts as a miss
        _note_autotune_miss(key, backend)
    bco = bco or over.get("bco")
    bho = bho or over.get("bho")
    if bc is None:
        if pool is not None:
            bc = cin
        elif over.get("bc"):
            bc = _divisor_at_most(cin, over["bc"])
        else:
            bc = split_fallback(m=batch * ho * wo, cin=cin, cout=cout, kh=kh,
                                kw=kw, sms=sms)
    bco = min(bco or 128, cout)
    bho = min(bho or min(ho, 128), ho)
    if pool is not None:
        ph = pool[0]
        bho = max(ph, bho - bho % ph)
    return bho, bco, bc


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


def conv_out_size(size: int, k: int, stride: int, padding: int,
                  dilation: int) -> int:
    return (size + 2 * padding - (k - 1) * dilation - 1) // stride + 1


def a_loader(cin: int, x_ptr: int, kspan: int = 0) -> str:
    """The A loader of K3 and K3b (``pool=``): ``"vector"`` when a 16-byte
    chunk of a reduction row is one tap's channels of one pixel, at an
    aligned address (Cin % 16 == 0 and the activations 16-byte aligned;
    with split-K, each split's ``kspan`` codes a multiple of 16 too), else
    ``"byte"``."""
    ok = (cin % VECTOR_BYTES == 0 and x_ptr % VECTOR_BYTES == 0
          and kspan % VECTOR_BYTES == 0)
    return "vector" if ok else "byte"


def check_weights(what: str, w_codes: torch.Tensor, taps: int, cin: int,
                  weight_format: str) -> int:
    """Check conv weights against their format's layout, (taps*cin, Cout)
    int8 or (taps*cin_p/factor, Cout) packed uint8; returns the factor."""
    factor = format_factor(weight_format)
    cin_p = -(-cin // factor) * factor
    if w_codes.shape[0] * factor != taps * cin_p:
        raise ValueError(f"{what}: weights {tuple(w_codes.shape)} do not "
                         f"match {taps} taps x cin={cin} ({weight_format}, "
                         f"cin_p={cin_p})")
    if factor > 1 and w_codes.dtype != torch.uint8:
        raise ValueError(f"{what}: {weight_format} weights are packed "
                         f"uint8, got {w_codes.dtype}")
    return factor


def fq_conv2d(a_codes: torch.Tensor, w_codes: torch.Tensor,
              scale: torch.Tensor, *, kh: int, kw: int,
              stride: Tuple[int, int] = (1, 1),
              padding: Tuple[int, int] = (0, 0),
              dilation: Tuple[int, int] = (1, 1),
              pool: Optional[Tuple[int, int]] = None,
              epilogue: str = "requant", n_out: int = 7,
              lo: int = 0, weight_format: str = "int8",
              bho: Optional[int] = None, bco: Optional[int] = None,
              bc: Optional[int] = None, noise_sigma_acc=None,
              noise_seed=None, mac_chunks: int = 1) -> torch.Tensor:
    """Fused int8 NHWC conv2d with the requant/dequant epilogue.

    ``pool=(ph, pw)`` fuses a non-overlapping max-pool, floor mode, on the
    int32 accumulator before the epilogue (K3b); its launches are counted
    on :func:`fq_conv2d_pool`. ``weight_format`` "int4" or "ternary" takes
    packed weights, (kh*kw*cin_p/factor, Cout) uint8. ``noise_sigma_acc``,
    ``noise_seed`` and ``mac_chunks`` turn on the ADC noise, as in
    :func:`.fq_matmul.fq_matmul`. ``bho``, ``bco`` and ``bc`` are the
    reference's block knobs, through :func:`pick_blocks`: an unpooled int8
    conv whose ``bc`` (explicit, from the table or the fallback) is below
    Cin runs split-K on the card, with the same result.
    """
    what = "fq_conv2d" if pool is None else "fq_conv2d_pool"
    noisy = check_noise(what, noise_sigma_acc, noise_seed, mac_chunks)
    b, h, w, cin = a_codes.shape
    cout = w_codes.shape[1]
    factor = check_weights("fq_conv2d", w_codes, kh * kw, cin, weight_format)
    ho = conv_out_size(h, kh, stride[0], padding[0], dilation[0])
    wo = conv_out_size(w, kw, stride[1], padding[1], dilation[1])
    if ho <= 0 or wo <= 0:
        raise ValueError(f"fq_conv2d: empty output for input "
                         f"{tuple(a_codes.shape)}, kernel ({kh}, {kw}), "
                         f"stride {stride}, padding {padding}, dilation "
                         f"{dilation}")
    if pool is not None:
        if min(pool) < 1 or ho < pool[0] or wo < pool[1]:
            raise ValueError(f"fq_conv2d: pool {pool} does not fit the conv "
                             f"output ({ho}, {wo})")
    if a_codes.device.type == "cpu":
        check_blocks(cin, bc, weight_format)
        return fq_conv2d_plain(a_codes, w_codes, scale, kh=kh, kw=kw,
                               stride=stride, padding=padding,
                               dilation=dilation, pool=pool,
                               epilogue=epilogue, n_out=n_out, lo=lo,
                               weight_format=weight_format,
                               noise_sigma_acc=noise_sigma_acc,
                               noise_seed=noise_seed, mac_chunks=mac_chunks)
    check_operands(what, scale, epilogue, a_codes, w_codes, weight_format)
    sigma, seed = (noise_pointers(what, a_codes.device, noise_sigma_acc,
                                  noise_seed) if noisy else (None, None))
    if a_codes.numel() >= 2 ** 31:
        raise ValueError(f"{what}: the CUDA kernel indexes activations "
                         "with 32-bit offsets (< 2^31 elements)")
    _, _, bc = pick_blocks(ho=ho, wo=wo, cin=cin, cout=cout, kh=kh, kw=kw,
                           stride=stride, pool=pool, bho=bho, bco=bco, bc=bc,
                           weight_format=weight_format, batch=b,
                           sms=_build.sm_count(a_codes.device))
    split = cin // bc if pool is None and factor == 1 else 1
    dequant = epilogue == "dequant"
    oh, ow = (ho, wo) if pool is None else (ho // pool[0], wo // pool[1])
    out = torch.empty((b, oh, ow, cout), device=a_codes.device,
                      dtype=torch.float32 if dequant else torch.int8)
    lib = _build.library("fq_conv", _SIG)
    shape = (b, h, w, cin, cout, kh, kw, *stride, *padding, *dilation, ho, wo)
    tail = (factor, int(dequant), int(lo), int(n_out), mac_chunks)
    kspan = kh * kw * bc if split > 1 else 0
    vector = a_loader(cin, a_codes.data_ptr(), kspan) == "vector"
    bvec = b_vector(cout, w_codes.data_ptr())
    with torch.cuda.device(a_codes.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        ptrs = (_build.ptr(a_codes), _build.ptr(w_codes), _build.ptr(scale),
                _build.ptr(out), sigma, seed)
        if split > 1:
            err = lib.fq_conv2d_splitk_s8(*ptrs, *shape, split, kspan,
                                          *tail[1:], int(vector), int(bvec),
                                          stream)
        elif pool is None:
            err = lib.fq_conv2d_s8(*ptrs, *shape, *tail, int(vector),
                                   int(bvec), stream)
        else:
            err = lib.fq_conv2d_pool_s8(*ptrs, *shape, *pool, *tail,
                                        int(vector), int(bvec), stream)
    _build.check(err, what + (" (split-K)" if split > 1 else ""), lib)
    _count(fq_conv2d if pool is None else fq_conv2d_pool, weight_format,
           noisy, vector)
    if split > 1:
        fq_conv2d.split_launches += 1
    return out


def _count(counted, weight_format: str, noisy: bool, vector: bool) -> None:
    """One launch on the counters of ``counted`` (fq_conv2d or
    fq_conv2d_pool)."""
    counted.launches += 1
    if weight_format != "int8":
        counted.packed_launches[weight_format] += 1
    if noisy:
        counted.noisy_launches += 1
    if vector:
        counted.vector_launches += 1


fq_conv2d.launches = 0
fq_conv2d.packed_launches = packed_counts()
fq_conv2d.noisy_launches = 0
fq_conv2d.vector_launches = 0
fq_conv2d.split_launches = 0


def fq_conv2d_pool(a_codes: torch.Tensor, w_codes: torch.Tensor,
                   scale: torch.Tensor, *, kh: int, kw: int,
                   pool: Tuple[int, int], **opts) -> torch.Tensor:
    """K3b: :func:`fq_conv2d` with the fused max-pool epilogue."""
    return fq_conv2d(a_codes, w_codes, scale, kh=kh, kw=kw, pool=pool,
                     **opts)


fq_conv2d_pool.launches = 0
fq_conv2d_pool.packed_launches = packed_counts()
fq_conv2d_pool.noisy_launches = 0
fq_conv2d_pool.vector_launches = 0


def fq_conv1d(a_codes: torch.Tensor, w_codes: torch.Tensor,
              scale: torch.Tensor, *, ksize: int, dilation: int = 1,
              epilogue: str = "requant", n_out: int = 7,
              lo: int = 0, weight_format: str = "int8",
              bho: Optional[int] = None, bco: Optional[int] = None,
              bc: Optional[int] = None, noise_sigma_acc=None,
              noise_seed=None, mac_chunks: int = 1) -> torch.Tensor:
    """Fused int8 1-D conv (VALID, dilated: the paper's KWS layers).

    A (ksize, 1) conv2d over a width-1 axis: conv1d's tap-major weights are
    exactly the kw=1 conv2d layout, and the views below copy nothing. The
    output index (b * T_out + t) * Cout + c is the conv2d one at Wo = 1.
    """
    y = fq_conv2d(a_codes.unsqueeze(2), w_codes, scale, kh=ksize, kw=1,
                  dilation=(dilation, 1), epilogue=epilogue, n_out=n_out,
                  lo=lo, weight_format=weight_format, bho=bho, bco=bco,
                  bc=bc, noise_sigma_acc=noise_sigma_acc,
                  noise_seed=noise_seed, mac_chunks=mac_chunks)
    return y.squeeze(2)
