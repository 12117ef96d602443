"""Where a tile's time goes in the Hopper bf16 cmconv kernel (`csrc/cmconv_bf16_sm90.cu`).

Builds a copy of the kernel's source with `clock64()` stamps between the
phases of its tile loop (the ring wait, the transpose, the staging issue,
the products, the epilogue, the store), summed by thread 0 of every block
into a `__device__` array, and prints the cycles a tile of each phase at the
bf16 defender step's b24 shapes. The kernel in the package is not touched:
the copy is built into `_build/` beside it.

    python -m mladversarialobjectdetection_torch.ops.cmconv_profile

Needs a CUDA card and nvcc. Thread 0's cycles include the time its warp
waits for issue slots and shared memory while the SM's other warps run, so
the phases' shares, not their sums, are the reading.
"""
from __future__ import annotations

import ctypes
import subprocess

from .. import _build

PHASES = ("ring wait", "transpose", "barrier", "staging issue", "products",
          "barrier", "epilogue", "store")
# (source line the stamp follows or precedes, its replacement): MARK(k) adds
# the cycles since the last stamp to phase k
_STAMPS = (
    ("namespace {\n\nconstexpr int kThreads",
     "__device__ unsigned long long g_prof[16];\nnamespace {\n\nconstexpr int kThreads"),
    ("  int slot = 0;\n",
     "  int slot = 0;\n  long long tp[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n  long long c_last = clock64();\n"
     "  int n_tiles = 0;\n#define MARK(k) { const long long c_ = clock64(); tp[k] += c_ - c_last; "
     "c_last = c_; }\n"),
    ("    cp_async_wait<S - 2>();\n    __syncthreads();  // this tile is staged; the last output"
     " tile is stored\n",
     "    ++n_tiles;\n    cp_async_wait<S - 2>();\n    __syncthreads();  // this tile is staged; the"
     " last output tile is stored\n    MARK(0)\n"),
    ("    __syncthreads();  // the slot is free: it takes the tile S - 1 ahead\n",
     "    MARK(1)\n    __syncthreads();  // the slot is free: it takes the tile S - 1 ahead\n"
     "    MARK(2)\n"),
    ("    float acc[MT][NT][4];\n", "    MARK(3)\n    float acc[MT][NT][4];\n"),
    ("    __syncthreads();  // the channels-last tile is read: its room takes the output tile\n",
     "    MARK(4)\n    __syncthreads();  // the channels-last tile is read: its room takes the"
     " output tile\n    MARK(5)\n"),
    ("    // 16 bytes a lane, 8 lanes a row", "    MARK(6)\n    // 16 bytes a lane, 8 lanes a row"),
    ("          for (int k = 0; k < n; ++k) dst[k] = src[k];\n        }\n      }\n    }\n  }\n}\n",
     "          for (int k = 0; k < n; ++k) dst[k] = src[k];\n        }\n      }\n    }\n"
     "    MARK(7)\n  }\n  if (threadIdx.x == 0) {\n    for (int k = 0; k < 8; ++k) "
     "atomicAdd(&g_prof[k], static_cast<unsigned long long>(tp[k]));\n"
     "    atomicAdd(&g_prof[8], static_cast<unsigned long long>(n_tiles));\n  }\n}\n"),
)
_READER = """
extern "C" int mlad_cmconv_profile(unsigned long long* host, int reset) {
  if (reset) {
    const unsigned long long zero[16] = {};
    return static_cast<int>(cudaMemcpyToSymbol(g_prof, zero, sizeof(zero)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_prof, 16 * sizeof(unsigned long long)));
}
"""
# (C, Co, side) of the bf16 defender step's launches at b24, each once
SHAPES = ((3, 8, 640), (8, 8, 640), (16, 8, 640), (8, 16, 640), (8, 16, 320),
          (16, 16, 320), (16, 8, 320), (32, 16, 320), (16, 32, 320))


def instrumented_source() -> str:
    """The kernel's source with the clock64 stamps; raises if the tile loop
    no longer has the lines they follow."""
    src = (_build.CSRC_DIR / "cmconv_bf16_sm90.cu").read_text()
    for anchor, stamped in _STAMPS:
        if src.count(anchor) != 1:
            raise ValueError(f"cmconv_bf16_sm90.cu: {anchor!r} found {src.count(anchor)} times")
        src = src.replace(anchor, stamped)
    return src + _READER


def build() -> ctypes.CDLL:
    """Compile the instrumented copy with the package's nvcc flags."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "cmconv_bf16_sm90_profile.cu"
    cu.write_text(instrumented_source())
    lib = cu.with_suffix(".so")
    proc = subprocess.run(["/usr/local/cuda/bin/nvcc", *_build.NVCC_FLAGS, "-I",
                           str(_build.CSRC_DIR), "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc exit {proc.returncode}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("cmconv_profile needs a CUDA card")
    lib = build()
    fn = lib.mlad_cmconv3x3_bf16_sm90
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    lib.mlad_cmconv_profile.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    for c, co, side in SHAPES:
        x = torch.randn((24, c, side, side), device=dev, generator=gen).bfloat16()
        w = (torch.randn((3, 3, c, co), device=dev, generator=gen) * 0.3).bfloat16().float()
        out = torch.empty((24, co, side, side), device=dev, dtype=torch.bfloat16)
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            err = fn(x.data_ptr(), w.data_ptr(), None, 24, c, co, side, side, out.data_ptr(),
                     stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError_t {err}")

        launch()
        torch.cuda.synchronize()
        lib.mlad_cmconv_profile(None, 1)
        launch()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 16)()
        lib.mlad_cmconv_profile(ctypes.addressof(buf), 0)
        tiles = buf[8]
        total = sum(buf[:8]) / tiles
        print(f"{c} -> {co} at {side}, b24: {tiles} tiles, {total:.0f} cycles a tile (thread 0): "
              + ", ".join(f"{name} {buf[k] / tiles:.0f} ({buf[k] / tiles / total:.0%})"
                          for k, name in enumerate(PHASES)))


if __name__ == "__main__":
    main()
