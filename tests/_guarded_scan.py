"""Run the selective-scan backward on the card with each input ending where
its mapped device memory ends, the next granule of address space reserved
and left unmapped, so that a read of any byte past an input faults.

    PYTHONPATH=src python tests/_guarded_scan.py [LIBRARY]

At B 2, S 75, D 100, x, B and C in bf16 (x's rows start off 16 bytes, B
and C are column slices of one projection, and the grid's last block lies
past D), with a final-state cotangent.  ``LIBRARY``: a build of the
kernel's source to launch in place of the checkout's.  Prints a line
``placed`` once the inputs lie in the guarded memory, then one JSON object:
each gradient's error against ``ref.selective_scan_bwd_ref`` as the card
tests take it (dx and ddt row by row, dA, dB and dC relative to their
largest |value|).  A read past an input ends the process with CUDA's
illegal memory access.
"""

from __future__ import annotations

import ctypes
import json
import sys

import torch

from repro_torch.kernels.selective_scan import build, ops, ref

B, S, D, N, R = 2, 75, 100, 16, 8


class _Prop(ctypes.Structure):              # CUmemAllocationProp
    _fields_ = [("type", ctypes.c_int), ("handle_types", ctypes.c_int),
                ("loc_type", ctypes.c_int), ("loc_id", ctypes.c_int),
                ("win32", ctypes.c_void_p), ("compression", ctypes.c_ubyte),
                ("rdma", ctypes.c_ubyte), ("usage", ctypes.c_ushort),
                ("reserved", ctypes.c_ubyte * 4)]


class _Access(ctypes.Structure):            # CUmemAccessDesc
    _fields_ = [("loc_type", ctypes.c_int), ("loc_id", ctypes.c_int),
                ("flags", ctypes.c_int)]


_PINNED, _DEVICE, _READ_WRITE = 1, 1, 3
_cu = ctypes.CDLL("libcuda.so.1")
_u64, _size = ctypes.c_uint64, ctypes.c_size_t
_cu.cuMemGetAllocationGranularity.argtypes = [
    ctypes.POINTER(_size), ctypes.POINTER(_Prop), ctypes.c_int]
_cu.cuMemAddressReserve.argtypes = [ctypes.POINTER(_u64), _size, _size,
                                    _u64, ctypes.c_ulonglong]
_cu.cuMemCreate.argtypes = [ctypes.POINTER(_u64), _size,
                            ctypes.POINTER(_Prop), ctypes.c_ulonglong]
_cu.cuMemMap.argtypes = [_u64, _size, _size, _u64, ctypes.c_ulonglong]
_cu.cuMemSetAccess.argtypes = [_u64, _size, ctypes.POINTER(_Access), _size]


def _ok(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} failed with CUDA driver error {rc}")


class _Guarded:
    """``nbytes`` of device memory whose last byte is the last one mapped:
    whole granules mapped, and one more reserved but not mapped."""

    def __init__(self, nbytes: int, device: int):
        prop = _Prop(type=_PINNED, loc_type=_DEVICE, loc_id=device)
        gran = _size()
        _ok(_cu.cuMemGetAllocationGranularity(ctypes.byref(gran),
                                              ctypes.byref(prop), 0),
            "cuMemGetAllocationGranularity")
        size = -(-nbytes // gran.value) * gran.value
        va, handle = _u64(), _u64()
        _ok(_cu.cuMemAddressReserve(ctypes.byref(va), size + gran.value, 0,
                                    0, 0), "cuMemAddressReserve")
        _ok(_cu.cuMemCreate(ctypes.byref(handle), size, ctypes.byref(prop),
                            0), "cuMemCreate")
        _ok(_cu.cuMemMap(va, size, 0, handle, 0), "cuMemMap")
        access = _Access(loc_type=_DEVICE, loc_id=device, flags=_READ_WRITE)
        _ok(_cu.cuMemSetAccess(va, size, ctypes.byref(access), 1),
            "cuMemSetAccess")
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "version": 3,
            "data": (va.value + size - nbytes, False)}


def guarded(t: torch.Tensor, keep: list) -> torch.Tensor:
    """A copy of contiguous ``t`` whose last byte ends the mapped memory."""
    g = _Guarded(t.numel() * t.element_size(), t.device.index)
    keep.append(g)
    raw = torch.as_tensor(g, device=t.device)
    return raw.view(t.dtype).view(t.shape).copy_(t)


def main(argv: list[str]) -> None:
    card = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=card).manual_seed(21)
    x = torch.randn((B, S, D), generator=gen, device=card).to(torch.bfloat16)
    dbc = torch.randn((B, S, R + 2 * N), generator=gen,
                      device=card).to(torch.bfloat16)
    dt = torch.exp(torch.empty((B, S, D), device=card).uniform_(
        -6.9, -2.3, generator=gen))
    A = -torch.arange(1, N + 1, dtype=torch.float32,
                      device=card).expand(D, N).contiguous()
    gy = torch.randn((B, S, D), generator=gen, device=card)
    gh = torch.randn((B, D, N), generator=gen, device=card)
    keep: list = []
    x, dbc, dt, A, gy, gh = (guarded(t, keep)
                             for t in (x, dbc, dt, A, gy, gh))
    _, Bm, Cm = dbc.split([R, N, N], dim=-1)
    torch.cuda.synchronize()
    print("placed", flush=True)
    if argv:
        lib = build.typed(ctypes.CDLL(argv[0]))
        build.load = lambda: lib
    got = ops.selective_scan_bwd(x, dt, A, Bm, Cm, gy, gh)
    torch.cuda.synchronize()
    want = ref.selective_scan_bwd_ref(x, dt, A, Bm, Cm, gy, gh)
    errs = {k: float(ref.row_errors(g, w).max())
            for k, g, w in zip(("dx_row", "ddt_row"), got, want)}
    errs.update({k: float((g - w).abs().max() / w.abs().max())
                 for k, g, w in zip(("dA", "dB", "dC"), got[2:], want[2:])})
    print(json.dumps(errs), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
