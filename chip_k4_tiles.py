"""Time K4's bf16 kernel with 128- and 256-wide output tiles on one card.

    python3 chip_k4_tiles.py

Builds ``autodist_tpu_torch/kernels/csrc/conv_bn.cu`` twice with ``nvcc``
(both at once), with ``-DCB_BLOCK_N=128`` and ``-DCB_BLOCK_N=256``: the
output channels of the bf16 kernel's tile wherever Cout allows them. At
each of ResNet-101's main-path shapes (``chip_smoke.RESNET_K4``) it holds
each build against the plain version (``chip_smoke.K4_TOL``), then times
the two in turns (128, 256, 256, 128; CUDA events over 20 launches each,
through the wrapper), and prints one JSON line per shape and a last line
with the launch-weighted means, beside the card's name and power limit.
It needs a card; it fails without one.
"""
import ctypes
import json
import os
import subprocess
import sys

import torch

import chip_smoke
from autodist_tpu_torch.kernels import build
from autodist_tpu_torch.kernels import conv_bn as cb

WIDTHS = (128, 256)


def build_variants():
    """{tile width: loaded library}, one nvcc per width, all at once."""
    out_dir = os.path.join(build.BUILD_DIR, 'k4_tiles')
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for bn in WIDTHS:
        out = os.path.join(out_dir, 'libconv_bn_%d.so' % bn)
        cmd = [build.nvcc_path(), *build.ARCH_FLAGS, '-std=c++17', '-O3',
               '-shared', '-Xcompiler', '-fPIC', '-DCB_BLOCK_N=%d' % bn,
               os.path.join(build.CSRC_DIR, cb.SOURCE), '-o', out]
        procs[bn] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True),
                     out)
    libs = {}
    for bn, (proc, out) in procs.items():
        log, _ = proc.communicate()
        chip_smoke.require(proc.returncode == 0,
                           'nvcc failed for width %d:\n%s' % (bn, log))
        lib = ctypes.CDLL(out)
        for name, argtypes in cb._SIGNATURES.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        libs[bn] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        print('chip_k4_tiles: no CUDA device', file=sys.stderr)
        return 1
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = build_variants()
    means = {bn: 0.0 for bn in WIDTHS}
    for shape in chip_smoke.RESNET_K4:
        n, c_in, c_out, relu, calls = shape[:5]
        gen = torch.Generator(device='cuda').manual_seed(3)
        x = torch.randn((n, c_in), generator=gen,
                        device='cuda').to(torch.bfloat16)
        w = torch.randn((c_in, c_out), generator=gen, device='cuda') * \
            c_in ** -0.5
        a = b = None
        if relu:
            a = torch.rand(c_in, generator=gen, device='cuda') + 0.5
            b = torch.randn(c_in, generator=gen, device='cuda')
        args = (x, w, a, b, relu, True, torch.bfloat16)
        want = cb._fwd_plain(*args)
        rec = {}
        for bn in WIDTHS:
            cb._lib = libs[bn]
            got = cb._fwd_cuda(*args)
            torch.cuda.synchronize()
            tol = chip_smoke.K4_TOL[torch.bfloat16]
            for g, p, rel in zip(got, want, (tol['y'], tol['s'], tol['s'])):
                err = float((g.float() - p.float()).abs().max())
                chip_smoke.require(
                    err <= rel * float(p.float().abs().max()),
                    'width %d disagrees at %s' % (bn, shape[:3]))
            rec[bn] = {'block_n': libs[bn].cb_block_n(c_out), 'ms': []}
        for bn in WIDTHS + WIDTHS[::-1]:
            cb._lib = libs[bn]
            rec[bn]['ms'].append(chip_smoke.cuda_ms(
                lambda: cb._fwd_cuda(*args), 20))
        cb._lib = None
        for bn in WIDTHS:
            rec[bn]['mean_ms'] = sum(rec[bn]['ms']) / 2
            means[bn] += calls / chip_smoke.RESNET_K4_PER_STEP * \
                rec[bn]['mean_ms']
        chip_smoke.emit(phase='k4_tiles', rows=n, c_in=c_in, c_out=c_out,
                        prologue_relu=relu, calls_per_step=calls,
                        bound_ms=chip_smoke.bound_conv_bn(
                            n, c_in, c_out, torch.bfloat16, relu)[0],
                        card=smi, **{'bn%d' % bn: rec[bn] for bn in WIDTHS})
    chip_smoke.emit(phase='k4_tiles_mean', order='128 256 256 128',
                    launch_weighted_ms={str(bn): means[bn] for bn in WIDTHS},
                    card=smi)
    return 0


if __name__ == '__main__':
    sys.exit(main())
