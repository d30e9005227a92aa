"""Bucket wire codec: the counterpart of `repro.kernels.bucket_codec`'s table,
`pack`, `unpack` and `adamw_update_shard`.

The explicit-DP step packs every gradient leaf into one stacked
`(n_buckets, bucket_elems)` carrier in the wire dtype (fp32, bf16, or int8
with per-bucket scales and error feedback), reduces it row by row, and
unpacks it back into per-leaf fp32 tensors. The address table (`CodecTable`,
`make_table`) is the JAX package's, built from `core.overlap.make_buckets`,
so both packages cut the gradient stream at the same places.

Dispatch is by the tensors' device and by nothing else, as in `ops`: CPU
tensors take the plain versions (`ref.pack_ref`, `ref.unpack_ref`); CUDA
tensors take the hand-written kernels csrc/bucket_pack.cu (K3, replacing the
Pallas `_pack_kernel`), csrc/bucket_unpack.cu (K4, replacing
`_unpack_kernel`) and csrc/adamw_shard.cu (K5, replacing
`_adamw_shard_kernel`: the ZeRO step's fused update of one carrier shard), or
raise. Each public call that launches counts one launch (the int8 pack's and
the int8 update's two passes are one call).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..core.overlap import make_buckets
from . import _build, ref

# wire name -> torch dtype on the wire
WIRE_DTYPES = {
    "fp32": torch.float32,
    "bf16": torch.bfloat16,
    "int8": torch.int8,
}
# Wire dtype codes shared with csrc/common.cuh.
WIRE_CODES = {"fp32": 0, "bf16": 1, "int8": 2}
MAX_LEAVES = 128  # csrc/codec.cuh kMaxLeaves: the table travels in kernel parameters

# Launches of each kernel since the last reset (ops.reset_launch_counts).
pack_launches = 0
unpack_launches = 0
adamw_launches = 0


@dataclasses.dataclass(frozen=True)
class CodecTable:
    """Static address table of the codec, one per tree structure.

    `spans[k]` lists bucket k's copies as (leaf, src_lo, src_hi, dst_lo):
    carrier row k positions [dst_lo, dst_lo + (src_hi - src_lo)) hold leaf
    elements [src_lo, src_hi).  Because `make_buckets` walks leaves in a fixed
    order and splits them only at bucket boundaries, every leaf also occupies
    one *contiguous* range of the flattened carrier starting at
    `leaf_offsets[i]`, which is what the kernels address by.
    Zero-size leaves own no span and `leaf_offsets[i]` is -1.
    """

    sizes: Tuple[int, ...]
    bucket_elems: int
    reverse: bool
    spans: Tuple[Tuple[Tuple[int, int, int, int], ...], ...]
    leaf_offsets: Tuple[int, ...]

    @property
    def n_buckets(self) -> int:
        return len(self.spans)

    @property
    def total_elems(self) -> int:
        return sum(self.sizes)

    @property
    def carrier_elems(self) -> int:
        return self.n_buckets * self.bucket_elems

    def live_order(self) -> List[int]:
        """The non-empty leaves in carrier order (ascending offset): their
        ranges tile [0, total_elems)."""
        return sorted((i for i, s in enumerate(self.sizes) if s > 0),
                      key=lambda i: self.leaf_offsets[i])


def make_table(sizes: Sequence[int], bucket_elems: int,
               reverse: bool = True) -> CodecTable:
    """Build the address table from the bucket assignment: the codec and
    `core.overlap` share one boundary algorithm by construction."""
    sizes = tuple(int(s) for s in sizes)
    buckets = make_buckets(sizes, bucket_elems, reverse=reverse)
    cap = buckets[0].elems if buckets else max(int(bucket_elems), 1)
    offsets = [-1] * len(sizes)
    spans: List[Tuple[Tuple[int, int, int, int], ...]] = []
    for k, b in enumerate(buckets):
        dst = 0
        row = []
        for i, lo, hi in b.spans:
            row.append((i, lo, hi, dst))
            if lo == 0:
                offsets[i] = k * cap + dst
            dst += hi - lo
        spans.append(tuple(row))
    return CodecTable(sizes, cap, reverse, tuple(spans), tuple(offsets))


# ------------------------------------------------------------ CUDA launchers
def _table_args(table: CodecTable, tensors: Sequence[torch.Tensor]):
    """Host arrays of the live leaves' pointers and carrier offsets, in
    carrier order, for a kernel's LeafTable."""
    order = table.live_order()
    if len(order) > MAX_LEAVES:
        raise ValueError(f"the codec kernels take at most {MAX_LEAVES} non-empty leaves, "
                         f"got {len(order)}")
    ptrs = (ctypes.c_ulonglong * len(order))(*(tensors[i].data_ptr() for i in order))
    starts = (ctypes.c_longlong * (len(order) + 1))(
        *(table.leaf_offsets[i] for i in order), table.total_elems)
    return ptrs, starts, len(order)


def _pack_entry():
    lib = _build.library("bucket_pack")
    fn = lib.bucket_pack
    fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.POINTER(ctypes.c_longlong),
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.bucket_pack_chunks.argtypes = [ctypes.c_longlong]
    lib.bucket_pack_chunks.restype = ctypes.c_longlong
    return lib, fn


def _check_leaves(table: CodecTable, flat_g: Sequence[torch.Tensor]) -> torch.dtype:
    """The one dtype of the live leaves, after checking what the kernel takes."""
    if len(flat_g) != len(table.sizes):
        raise ValueError(f"{len(flat_g)} leaves for a table of {len(table.sizes)}")
    live = [g for g, s in zip(flat_g, table.sizes) if s > 0]
    dtypes = {g.dtype for g in live}
    if len(dtypes) != 1 or next(iter(dtypes)) not in _build.DTYPE_CODES:
        raise ValueError(f"the pack kernel takes leaves of one dtype, float32 or bfloat16, "
                         f"got {sorted(str(d) for d in dtypes)}")
    for g, s in zip(flat_g, table.sizes):
        if g.numel() != s or not g.is_contiguous():
            raise ValueError(f"the pack kernel needs contiguous leaves of the table's sizes, "
                             f"got {tuple(g.shape)} for size {s}")
    return next(iter(dtypes))


def bucket_pack(table: CodecTable, flat_g: Sequence[torch.Tensor], scale: float, wire: str,
                err: Optional[torch.Tensor]):
    """K3 on the card: `pack` for CUDA leaves (see `pack` for the contract)."""
    global pack_launches
    dtype = _check_leaves(table, flat_g)
    dev = next(g.device for g, s in zip(flat_g, table.sizes) if s > 0)
    nb, cap = table.n_buckets, table.bucket_elems
    with_err = wire == "int8" and err is not None
    if with_err and (err.device != dev or err.dtype != torch.float32
                     or tuple(err.shape) != (nb, cap) or not err.is_contiguous()):
        raise ValueError(f"err must be a contiguous float32 ({nb}, {cap}) tensor on {dev}, "
                         f"got {err.dtype} {tuple(err.shape)} on {err.device}")
    lib, fn = _pack_entry()  # builds at first use; raises if it cannot
    ptrs, starts, n = _table_args(table, flat_g)
    out = torch.empty((nb, cap), dtype=WIRE_DTYPES[wire], device=dev)
    scales = new_err = partial = None
    if wire == "int8":
        scales = torch.empty((nb,), dtype=torch.float32, device=dev)
        new_err = torch.empty((nb, cap), dtype=torch.float32, device=dev)
        partial = torch.empty((nb, lib.bucket_pack_chunks(cap)), dtype=torch.float32, device=dev)
    ptr = lambda t: t.data_ptr() if t is not None else None
    with torch.cuda.device(dev):
        code = fn(ptrs, starts, n, _build.DTYPE_CODES[dtype], WIRE_CODES[wire], out.data_ptr(),
                  ptr(err) if with_err else None, ptr(new_err), ptr(scales), ptr(partial),
                  nb, cap, scale, _build.stream_of(out))
    _build.check(lib, code, "bucket_pack")
    pack_launches += 1
    return out, scales, (new_err if wire == "int8" else err)


def _unpack_entry():
    lib = _build.library("bucket_unpack")
    fn = lib.bucket_unpack
    fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.POINTER(ctypes.c_longlong),
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def bucket_unpack(table: CodecTable, carrier: torch.Tensor, like: Sequence[torch.Tensor],
                  scales: Optional[torch.Tensor]) -> List[torch.Tensor]:
    """K4 on the card: `unpack` for a CUDA carrier (see `unpack`)."""
    global unpack_launches
    nb, cap = table.n_buckets, table.bucket_elems
    wire = next((w for w, d in WIRE_DTYPES.items() if d == carrier.dtype), None)
    if wire is None or tuple(carrier.shape) != (nb, cap) or not carrier.is_contiguous():
        raise ValueError(f"the unpack kernel takes a contiguous ({nb}, {cap}) carrier of a "
                         f"wire dtype, got {carrier.dtype} {tuple(carrier.shape)}")
    if scales is not None and (scales.device != carrier.device or scales.dtype != torch.float32
                               or tuple(scales.shape) != (nb,) or not scales.is_contiguous()):
        raise ValueError(f"scales must be a contiguous float32 ({nb},) tensor on the "
                         f"carrier's device")
    if len(like) != len(table.sizes):
        raise ValueError(f"{len(like)} leaves for a table of {len(table.sizes)}")
    lib, fn = _unpack_entry()  # builds at first use; raises if it cannot
    out = [torch.empty(g.shape, dtype=torch.float32, device=carrier.device) if s > 0
           else torch.zeros(g.shape, dtype=torch.float32, device=carrier.device)
           for g, s in zip(like, table.sizes)]
    ptrs, starts, n = _table_args(table, out)
    with torch.cuda.device(carrier.device):
        code = fn(ptrs, starts, n, WIRE_CODES[wire], carrier.data_ptr(),
                  scales.data_ptr() if scales is not None else None, nb, cap,
                  _build.stream_of(carrier))
    _build.check(lib, code, "bucket_unpack")
    unpack_launches += 1
    return out


def _adamw_entry():
    lib = _build.library("adamw_shard")
    fn = lib.adamw_shard
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_longlong] * 2 + [ctypes.c_float] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.adamw_shard_chunks.argtypes = [ctypes.c_longlong]
    lib.adamw_shard_chunks.restype = ctypes.c_longlong
    return lib, fn


def adamw_shard(g, p, m, v, clip, lr, bc1, bc2, b1: float, b2: float, eps: float, wd: float,
                wire: str):
    """K5 on the card: `adamw_update_shard` for CUDA shards (see there)."""
    global adamw_launches
    dev = g.device
    for name, t in (("g", g), ("p", p), ("m", m), ("v", v)):
        if (t.device != dev or t.dtype != torch.float32 or t.dim() != 2
                or t.shape != g.shape or not t.is_contiguous()):
            raise ValueError(f"the AdamW shard kernel takes contiguous float32 (n_buckets, "
                             f"shard_elems) g, p, m and v of one shape on one device; {name} is "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    nb, sh = g.shape
    if nb == 0 or sh == 0:
        raise ValueError(f"the AdamW shard kernel needs a non-empty shard, got {(nb, sh)}")
    lib, fn = _adamw_entry()  # builds at first use; raises if it cannot
    # [clip, lr, bc1, bc2] as one fp32 buffer on the device, made on the stream
    # (no host read of a device scalar, so the call can be captured in a graph)
    scalars = torch.stack([torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(())
                           for x in (clip, lr, bc1, bc2)])
    out = torch.empty((nb, sh), dtype=WIRE_DTYPES[wire], device=dev)
    m_out, v_out = torch.empty_like(m), torch.empty_like(v)
    scratch = partial = scales = None
    if wire == "int8":
        scratch = torch.empty((nb, sh), dtype=torch.float32, device=dev)
        partial = torch.empty((nb, lib.adamw_shard_chunks(sh)), dtype=torch.float32, device=dev)
        scales = torch.empty((nb,), dtype=torch.float32, device=dev)
    ptr = lambda t: t.data_ptr() if t is not None else None
    with torch.cuda.device(dev):
        # 1 - b1 and 1 - b2 in double, rounded once to fp32 by ctypes: JAX's
        # weak-typed Python floats
        code = fn(g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(), scalars.data_ptr(),
                  WIRE_CODES[wire], out.data_ptr(), m_out.data_ptr(), v_out.data_ptr(),
                  ptr(scratch), ptr(partial), ptr(scales), nb, sh, b1, 1 - b1, b2, 1 - b2, eps,
                  wd, _build.stream_of(g))
    _build.check(lib, code, "adamw_shard")
    adamw_launches += 1
    return out, scales, m_out, v_out


# ------------------------------------------------------------------- public
def _device(tensors: Sequence[torch.Tensor]) -> torch.device:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(str(d) for d in devs)}")
    return next(iter(devs))


def pack(table: CodecTable, flat_g: Sequence[torch.Tensor], *, scale: float = 1.0,
         wire: str = "fp32", err: Optional[torch.Tensor] = None):
    """Fused gather + wire-quantize: leaves -> (carrier, scales, new_err).

    `carrier` is `(n_buckets, bucket_elems)` in the wire dtype; the final
    partial bucket is zero-padded (zeros are the reduction identity).  `scale`
    multiplies every element (the 1/n pre-division of a mean-reduce), as the
    fp32 value of the Python float.

    For ``wire="int8"``, `scales` holds the per-bucket symmetric quantization
    scales; `err` — a carrier-shaped fp32 error-feedback buffer — is added
    *after* scaling and before quantization, and `new_err` is the residual
    `packed - dequant(q)`.  For fp32/bf16 wires `scales` is None and `err`
    passes through untouched.
    """
    if wire not in WIRE_DTYPES:
        raise ValueError(f"unknown wire format {wire!r}; one of {sorted(WIRE_DTYPES)}")
    if table.n_buckets == 0:
        raise ValueError("cannot pack an empty table (no gradient elements)")
    dev = _device(list(flat_g) + ([err] if err is not None else []))
    if dev.type == "cpu":
        return ref.pack_ref(table, flat_g, scale, wire, err)
    return bucket_pack(table, flat_g, scale, wire, err)


def unpack(table: CodecTable, carrier, like: Sequence[torch.Tensor],
           scales: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """Fused dequantize + scatter: reduced carrier -> per-leaf fp32 tensors
    shaped like `like` (inverse of `pack` up to the wire dtype's rounding).
    Zero-size leaves come back as fp32 zeros.  `carrier` may also be a list of
    1-D rows; it is stacked once here."""
    if not isinstance(carrier, torch.Tensor):
        carrier = torch.stack(list(carrier))
    dev = _device([carrier] + ([scales] if scales is not None else []))
    if dev.type == "cpu":
        return ref.unpack_ref(table, carrier, like, scales)
    return bucket_unpack(table, carrier, like, scales)


def adamw_update_shard(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor, v: torch.Tensor, *,
                       clip, lr, bc1, bc2, b1: float, b2: float, eps: float,
                       weight_decay: float, wire: str = "fp32"):
    """Fused sharded AdamW: one device's `(n_buckets, shard_elems)` carrier
    shards of (reduced gradient, param, m, v), all fp32 -> (p_wire, p_scales,
    new_m, new_v): the ZeRO update between the reduce-scatter and the
    all-gather.

    Elementwise math is `optim.adamw.apply_updates`' in the same op order:
    `clip` is the global-norm clip factor (already combined across shards),
    `lr` the scheduled rate, `bc1`/`bc2` the bias corrections (fp32 tensors,
    read on the device); `b1`/`b2`/`eps`/`weight_decay` are constants.
    Zero-padded carrier columns stay zero through any number of steps.

    `wire` is the all-gather leg's format: fp32/bf16 cast `p_new` (scales is
    None); int8 requantizes per row with a symmetric scale, one fp32 scale per
    (bucket, device) shard. The moments stay fp32. New tensors are returned;
    nothing given is modified.
    """
    if wire not in WIRE_DTYPES:
        raise ValueError(f"unknown wire format {wire!r}; one of {sorted(WIRE_DTYPES)}")
    if _device([g, p, m, v]).type == "cpu":
        return ref.adamw_shard_ref(g, p, m, v, clip, lr, bc1, bc2, b1, b2, eps, weight_decay,
                                   wire)
    return adamw_shard(g, p, m, v, clip, lr, bc1, bc2, b1, b2, eps, weight_decay, wire)
