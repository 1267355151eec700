#!/usr/bin/env python3
"""What bounds kernels A (pre-warp), B (pyramid lookup), C (block-local
volume), D (block-local fine lookup from coordinates), G (SepConvGRU
direction), H (motion-encoder tail) and I (flow head) on the card.

Run from the repository root on a machine with an NVIDIA GPU and ``nvcc``:

    python3 tools/torch_kernel_ablate.py [--kernels ABCDGHI]

For each variant below of the kernels named by ``--kernels`` (default
ABCD) the tool copies the kernel's source from ``woft_tpu_torch/csrc/``
(``warp.cu``, ``corr_lookup.cu``, ``local_corr.cu``, ``local_lookup.cu``,
``gru.cu``, ``update_tail.cu``, ``flow_head.cu``) into a directory of its own under
``build/torch_kernels/ablate/``, applies the variant's textual
replacements to the source or to a copy of a header beside it (it stops
if a piece of text is not in exactly one of them, so the variants stay in
step with the kernels), builds the copy with the port's ``nvcc`` flags, and
times it with ``chip_smoke.py``'s ``time_ms`` at the 1280x720 main-path
shapes: kernel A at its three poses, kernel B dense (Q = 14,400) and
indexed (M = 4,500), kernel C in bf16 for the four levels of a flow in its
one launch, kernel D from coordinates in bf16 for the four levels of a
lookup on ``chip_smoke.py``'s smooth 720p field, kernel G along W and
along H and kernels H and I on ``chip_smoke.update_case``'s 90 x 160 loop
inputs. The sources in ``csrc/`` are not touched and no variant is used by
the port.

Two kinds of variant. Ablations compile a part of the work out (A, B: the
loads become arithmetic on the address, the stores a branch that is never
taken; C: the producer arrives without loading the window slices, the
``wgmma`` products or the TMA stores are left out; D: no staging copies, no
stores; G, H, I: the producer arrives without the TMA tap loads, or the
``wgmma`` products, the output stores, the tile loads, G's epilogue loads,
H's epilogues or I's second-stage products are left out, or the grid
returns at once; H also with one of its two launches left out, alone and
combined with the others, which splits its time by stage):
their results are wrong by design and are not compared; the time that is
left says what the removed part costs. Layouts change which pixels a warp
owns, or (D) how many positions a CTA stages and how many CTAs share an
SM, or (G) the depth of the tap ring or the gates evaluated one by one
instead of read from their tables, or (G, I) a lone producer warp instead
of a producer warpgroup, or (H) its second launch issued after the first
ends instead of by programmatic dependent launch: they must still equal
the plain version (A, B, D: max abs error 0; C, G, H, I: within
``chip_smoke.py``'s tolerances). Imports no JAX.
"""

import argparse
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_B_LOAD = ("v[n] = valid ? load_widened(base + (gy * wl + gx)) : 0.f;",
           "v[n] = valid ? (float)(gy * wl + gx) : 0.f;")
_B_STORE = ("      o[c] = acc;\n", "      if (acc == 12345.678f) o[c] = acc;\n")
_A_LOADS = tuple(
    (f"v{c}[ch] = __ldg(p{c} + ch);", f"v{c}[ch] = (float)(c{o} + ch);")
    for c, o in (("00", "x0"), ("10", "x1"), ("01", "y0"), ("11", "y1")))
_A_STORE = ("      o[ch] = acc;\n    }\n  } else {",
            "      if (acc == 12345.678f) o[ch] = acc;\n    }\n  } else {")
_C_LOAD = ("mbar_expect_tx(full(s), bytes); tma_load_3d(ring + s * kSlice, "
           "&P.maps.win[l], kc * 64, x0, y0 + t * lv.rows, full(s));",
           "mbar_arrive(full(s));")
_C_PRODUCT = ("wgmma_m64n128k16(acc, sw128_desc(a + 32 * k), "
              "sw128_desc(bq + 32 * k), (kc | k) != 0);", ";")
_C_STORE = ("tma_store_3d(&P.maps.out[l], sb + h * kSlice, h * 64, t * m, b);",
            ";")
_D_STAGE = ("constexpr int kStagePositions = 320;",
            "constexpr int kStagePositions = {};")
_D_WARPS = ("constexpr int kWarps = 8;", "constexpr int kWarps = {};")
_D_EMPTY = ("  extern __shared__ __align__(16) unsigned char stage_raw[];\n",
            "  extern __shared__ __align__(16) unsigned char stage_raw[];\n"
            "  if (P.k > 0) return;\n")
_D_PROLOGUE = ("    if (staged) {\n      constexpr int kPerChunk",
               "    if (P.k > 0) {\n      if (nr * stride == 12345) "
               "P.bad_out[0] = 1;\n      continue;\n    }\n"
               "    if (staged) {\n      constexpr int kPerChunk")
_D_COPY = ("          cp_async16(dst", "          if (n < 0) cp_async16(dst")
_D_STORE = ("store(o + ((size_t)j * K + i - 1) * out_step, "
            "prev * gx + col * fx);",
            "if (col == 12345.678f) store(o + j * out_step, prev);")
# G and I: the shared pass is in conv_wgmma.cuh
_W_LOAD = ("mbar_expect_tx(full(s), bytes); tma_load_2d(stage(s), map, c0, "
           "c1, full(s));", "mbar_arrive(full(s));")
_W_PRODUCT = ("for (int k = 0; k < 4; ++k) wgmma_rs(acc, a[S][k], "
              "sw128_desc(b + 32 * k), (i | k) != 0);", ";")
_G_STORE = ("*reinterpret_cast<float2*>(out + 8 * (j0 + j)) = o[j];",
            "if (o[j].x == 12345.678f) out[0] = o[j].y;")
_G_RING = ("constexpr int kRing = 4;", "constexpr int kRing = {};")
_G_EMPTY = ("  extern __shared__ uint8_t smem_raw[];\n",
            "  extern __shared__ uint8_t smem_raw[];\n"
            "  if (P.len > 0) return;\n")
_I_STORE = ("P.out[((size_t)y * P.W + x) * 2 + ch] = sum + P.b2[ch];",
            "if (sum == 12345.678f) P.out[0] = sum;")
_I_EMPTY = ("  extern __shared__ uint8_t smem_raw[];\n",
            "  extern __shared__ uint8_t smem_raw[];\n"
            "  if (P.H > 0) return;\n")
_I_STAGE2 = ("      mma_bf16(c[0], af, bn0);\n      mma_bf16(c[1], af, bn1);\n"
             "      mma_bf16(c[2], af, bb);\n", "")
_G_TILE = (("load_quads_as_bf16<9>(", "if (P.len < 0) load_quads_as_bf16<9>("),
           ("    cp_async_16_zfill(As", "    if (P.len < 0) cp_async_16_zfill(As"))
_I_TILE = ("load_quads_as_bf16<11>(", "if (P.H < 0) load_quads_as_bf16<11>(")
# an epilogue left out still reads one accumulator, so that ptxas keeps the
# pass's wgmma (it drops instructions whose results nothing reads)
_G_NO_EPILOGUES = tuple(
    (head + "#pragma unroll\n  for (int hh = 0; hh < 2; ++hh) {",
     head + "if (acc[0] == 12345.678f) P.out[0] = acc[1];\n"
     "#pragma unroll\n  for (int hh = 0; hh < 0; ++hh) {")
    for head in (
        "kSlicesPerTap, ring, 0);\n",
        "// every warp's reads of h are done\n",
        "kSlicesPerTap, ring, 2 * kSlices);\n"))
_G_IDENTITY = (("  return v != v ? v : r;\n}", "  return v;\n}"),
               ("  return e < kTanhLo || v != v ? v", "  return true ? v"))
_G_DIRECT = (("  return make_float2(sigmoid_of(tab, v.x), sigmoid_of(tab, v.y));",
              "  return make_float2(sigmoid_direct(v.x), sigmoid_direct(v.y));"),
             ("  const float2 q = make_float2(tanh_of(tab, v.x), tanh_of(tab, v.y));",
              "  const float2 q = make_float2(tanh_direct(v.x), tanh_direct(v.y));"))
_G_EPI_LOADS = (
    ("  const unsigned int v = __ldg(reinterpret_cast<const unsigned int*>(p));",
     "  const unsigned int v = (unsigned int)(size_t)p;"),
    ("  return __ldg(reinterpret_cast<const float2*>(p));",
     "  return make_float2((float)(size_t)p, 0.f);"))
_G_WARP = (("constexpr int kBlock = kConsumers + 128;",
            "constexpr int kBlock = kConsumers + 32;"),
           ("    regs_down<40>();\n    if (warp == kConsumers / 32 && lane == 0) {",
            "    if (lane == 0) {"),
           ("  regs_up<232>();\n", ""))
_I_WARP = (_G_WARP[0], _G_WARP[1], ("  regs_up<152>();\n", ""))
# H: the C entry issues stage 1, then stage 2
_H_NO_STAGE2 = ("  return (int)cudaLaunchKernelEx(&cfg, motion_stage2_kernel, P2);",
                "  return (int)cudaGetLastError();")
_H_NO_PDL = ("  return (int)cudaLaunchKernelEx(&cfg, motion_stage2_kernel, P2);",
             "  motion_stage2_kernel<<<grid, kBlock, kSmem2, s>>>(P2);\n"
             "  return (int)cudaGetLastError();")
_H_NO_STAGE1 = ("  motion_stage1_kernel<<<grid, kBlock, kSmem1, s>>>(P1);\n"
                "  if ((err = cudaGetLastError()) != cudaSuccess) "
                "return (int)err;\n", "")
_H1_EPILOGUES = tuple(
    (f"    stage_rows(acc, {args}, row, cq);\n    named_sync(1, kConsumers);\n"
     f"    copy_out<",
     "    if (acc[0] == 12345.678f) P.mid[0] = __float2bfloat16(acc[1]);\n"
     "    if (P.H < 0) copy_out<")
    for args in ("bias + kCor2, flo", "bias, cor"))
_H2_EPILOGUE = (("  stage_rows(acc, bias, tile, row, cq);\n  if (cq == ",
                 "  if (acc[0] == 12345.678f) P.out[0] = __float2bfloat16(acc[1]);\n"
                 "  if (P.H < 0 && cq == "),
                ("  copy_out<kMotion, kMotion>(", "  if (P.H < 0) copy_out<kMotion, kMotion>("))
_H1_TILES = tuple((f"load_tile<{c}>(", f"if (P.H < 0) load_tile<{c}>(")
                  for c in ("kFlo", "kCor"))
_H2_TILE = (("load_tile<kMid>(", "if (P.H < 0) load_tile<kMid>("),)
_H_EMPTY = tuple((f"motion_stage{i}_kernel(const __grid_constant__ "
                  f"Stage{i}Params P) {{\n",
                  f"motion_stage{i}_kernel(const __grid_constant__ "
                  f"Stage{i}Params P) {{\n  if (P.H > 0) return;\n")
                 for i in (1, 2))
_A_PIXEL = (
    "  const int px = blockIdx.x * kTileW + (threadIdx.x & (kTileW - 1));\n"
    "  const int py = blockIdx.y * kTileH + threadIdx.x / kTileW;\n")


def _a_warp_shape(ww):
    """A warp owns ww x (32 / ww) pixels of the 32 x 8 tile, not 32 x 1."""
    per_row = 32 // ww
    return (_A_PIXEL,
            f"  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;\n"
            f"  const int px = blockIdx.x * kTileW + (wid % {per_row}) * {ww}"
            f" + lane % {ww};\n"
            f"  const int py = blockIdx.y * kTileH + (wid / {per_row}) * "
            f"{per_row} + lane / {ww};\n")


# name -> (source, replacements, results must equal the plain version)
VARIANTS = {
    "A as built": ("warp", (), True),
    "A without the loads": ("warp", _A_LOADS, False),
    "A without the stores": ("warp", (_A_STORE,), False),
    "A, a warp owns 16 x 2 pixels": ("warp", (_a_warp_shape(16),), True),
    "A, a warp owns 8 x 4 pixels": ("warp", (_a_warp_shape(8),), True),
    "A, tiles of 32 x 1 pixels": (
        "warp", (("constexpr int kTileH = 8;", "constexpr int kTileH = 1;"),),
        True),
    "B as built": ("corr_lookup", (), True),
    "B without the loads": ("corr_lookup", (_B_LOAD,), False),
    "B without the stores": ("corr_lookup", (_B_STORE,), False),
    "B without either": ("corr_lookup", (_B_LOAD, _B_STORE), False),
    "C as built": ("local_corr", (), True),
    "C without the window loads": ("local_corr", (_C_LOAD,), False),
    "C without the products": ("local_corr", (_C_PRODUCT,), False),
    "C without the stores": ("local_corr", (_C_STORE,), False),
    "C without loads and stores": ("local_corr", (_C_LOAD, _C_STORE), False),
    "C with none of the three": ("local_corr",
                                 (_C_LOAD, _C_PRODUCT, _C_STORE), False),
    "D as built": ("local_lookup", (), True),
    "D staging 288 positions a warp": (
        "local_lookup", ((_D_STAGE[0], _D_STAGE[1].format(288)),), True),
    "D staging 448 positions a warp": (
        "local_lookup", ((_D_STAGE[0], _D_STAGE[1].format(448)),), True),
    "D, 2 warps a CTA": (
        "local_lookup", ((_D_WARPS[0], _D_WARPS[1].format(2)),), True),
    "D, 4 warps a CTA": (
        "local_lookup", ((_D_WARPS[0], _D_WARPS[1].format(4)),), True),
    "D without the staging copies": ("local_lookup", (_D_COPY,), False),
    "D without the stores": ("local_lookup", (_D_STORE,), False),
    "D without either": ("local_lookup", (_D_COPY, _D_STORE), False),
    "D, its anchors and boxes only": ("local_lookup", (_D_PROLOGUE,), False),
    "D, an empty launch of its grid": ("local_lookup", (_D_EMPTY,), False),
    "G as built": ("gru", (), True),
    "G, a ring of 3 stages": ("gru", ((_G_RING[0], _G_RING[1].format(3)),),
                              True),

    "G, a producer warp instead of a warpgroup": ("gru", _G_WARP, True),
    "G without the TMA tap loads": ("gru", (_W_LOAD,), False),
    "G without the wgmma products": ("gru", (_W_PRODUCT,), False),
    "G without the output stores": ("gru", (_G_STORE,), False),
    "G without the tile loads": ("gru", _G_TILE, False),
    "G evaluating each gate's expf and tanhf (no tables)": (
        "gru", _G_DIRECT, True),
    "G without the epilogue loads": ("gru", _G_EPI_LOADS, False),
    "G without loads and products": ("gru", (_W_LOAD, _W_PRODUCT), False),
    "G without its three epilogues": ("gru", _G_NO_EPILOGUES, False),
    "G without the z epilogue": ("gru", _G_NO_EPILOGUES[:1], False),
    "G without the r epilogue": ("gru", _G_NO_EPILOGUES[1:2], False),
    "G without the q epilogue": ("gru", _G_NO_EPILOGUES[2:], False),
    "G with the gates' lookups left out": ("gru", _G_IDENTITY, False),
    "G without epilogues, loads and products": (
        "gru", _G_NO_EPILOGUES + (_W_LOAD, _W_PRODUCT), False),
    "G, an empty launch of its grid": ("gru", (_G_EMPTY,), False),
    "H as built": ("update_tail", (), True),
    "H, stage 2 launched after stage 1 ends (no programmatic dependent "
    "launch)": ("update_tail", (_H_NO_PDL,), True),
    "H without the TMA tap loads": ("update_tail", (_W_LOAD,), False),
    "H without the wgmma products": ("update_tail", (_W_PRODUCT,), False),
    "H without its epilogues": ("update_tail", _H1_EPILOGUES + _H2_EPILOGUE,
                                False),
    "H without the tile loads": ("update_tail", _H1_TILES + _H2_TILE, False),
    "H, empty launches of both grids": ("update_tail", _H_EMPTY, False),
    "H, stage 1 only": ("update_tail", (_H_NO_STAGE2,), False),
    "H, stage 1 only, without the TMA tap loads": (
        "update_tail", (_H_NO_STAGE2, _W_LOAD), False),
    "H, stage 1 only, without the wgmma products": (
        "update_tail", (_H_NO_STAGE2, _W_PRODUCT), False),
    "H, stage 1 only, without its epilogues": (
        "update_tail", (_H_NO_STAGE2,) + _H1_EPILOGUES, False),
    "H, stage 1 only, without the tile loads": (
        "update_tail", (_H_NO_STAGE2,) + _H1_TILES, False),
    "H, stage 2 only": ("update_tail", (_H_NO_STAGE1,), False),
    "H, stage 2 only, without the TMA tap loads": (
        "update_tail", (_H_NO_STAGE1, _W_LOAD), False),
    "H, stage 2 only, without the wgmma products": (
        "update_tail", (_H_NO_STAGE1, _W_PRODUCT), False),
    "H, stage 2 only, without its epilogue": (
        "update_tail", (_H_NO_STAGE1,) + _H2_EPILOGUE, False),
    "H, stage 2 only, without the tile load": (
        "update_tail", (_H_NO_STAGE1,) + _H2_TILE, False),
    "I as built": ("flow_head", (), True),
    "I, a producer warp instead of a warpgroup": ("flow_head", _I_WARP,
                                                   True),
    "I without the TMA tap loads": ("flow_head", (_W_LOAD,), False),
    "I without the wgmma products": ("flow_head", (_W_PRODUCT,), False),
    "I without the output stores": ("flow_head", (_I_STORE,), False),
    "I without its second stage's products": ("flow_head", (_I_STAGE2,),
                                              False),
    "I without the tile loads": ("flow_head", (_I_TILE,), False),
    "I without loads and products": ("flow_head", (_W_LOAD, _W_PRODUCT),
                                     False),
    "I, an empty launch of its grid": ("flow_head", (_I_EMPTY,), False),
}


def build_variants(kernels, letters):
    """One ``nvcc`` per variant of the kernels ``letters``, all started
    together -> {name: {C symbol: entry}}."""
    jobs = {}
    for i, (name, (source, replacements, _)) in enumerate(VARIANTS.items()):
        if name[0] not in letters:
            continue
        out_dir = kernels.BUILD_DIR / "ablate" / f"v{i}"
        out_dir.mkdir(parents=True, exist_ok=True)
        # the source and every header: a header that a replacement changes
        # is written beside the source, which its #include then finds first
        files = {f"{source}.cu": (kernels.CSRC / f"{source}.cu").read_text()}
        files.update((h.name, h.read_text())
                     for h in sorted(kernels.CSRC.glob("*.cuh")))
        changed = {f"{source}.cu"}
        for old, new in replacements:
            hits = [f for f, text in files.items() if text.count(old)]
            if len(hits) != 1 or files[hits[0]].count(old) != 1:
                raise SystemExit(f"variant '{name}': {old!r} is not in "
                                 f"exactly one place of {source}.cu and the "
                                 f"headers")
            files[hits[0]] = files[hits[0]].replace(old, new)
            changed.add(hits[0])
        for f in changed:
            (out_dir / f).write_text(files[f])
        cu, so = out_dir / f"{source}.cu", out_dir / f"lib{source}.so"
        jobs[name] = (so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC),
             "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant '{name}' does not build:\n{log}")
        lib = ctypes.CDLL(str(so))
        entries[name] = {}
        for symbol, argtypes in kernels._ENTRIES[VARIANTS[name][0]].items():
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            entries[name][symbol] = fn
    return entries


def local_corr_case(corr, dev):
    """Kernel C's 720p inputs in bf16: blocked queries, the four levels,
    their geometries, the plain volumes."""
    from woft_tpu_torch.ops.warp import avg_pool2d

    g = torch.Generator(device=dev).manual_seed(6)
    f1 = torch.randn(1, 90, 160, 256, device=dev, generator=g)
    f2 = torch.randn(1, 90, 160, 256, device=dev, generator=g)
    meta = corr._local_layout(90, 160, 4, 4, 16)
    nbh, nbw = meta["nbh"], meta["nbw"]
    f1b = corr._to_blocked(f1.reshape(-1, 256), meta).reshape(
        nbh * nbw, 128, 256).bfloat16().contiguous()
    levels = [f2]
    while len(levels) < 4:
        levels.append(avg_pool2d(levels[-1]))
    levels = [lv[0].bfloat16().contiguous() for lv in levels]
    geoms = [(d["pad"], d["sh"], d["sw"], d["wh"], d["ww"])
             for d in meta["levels"]]
    want = [corr.block_local_corr_plain(f1b, lv, d, nbh, nbw, torch.bfloat16)
            for lv, d in zip(levels, meta["levels"])]
    return (f1b, levels, geoms, nbh, nbw), want


def update_variant(kernels, cs, case, source, exact):
    """Kernel G along W and along H, or kernel H, or kernel I, of the build
    the wrappers launch -> (largest difference beyond ``chip_smoke.py``'s tolerance, 0.0
    when within it or not compared; the times)."""
    from woft_tpu_torch.models import update

    h, x = case["h"], case["x"]
    err, times = 0.0, []
    if source == "gru":
        allowed = cs.GRU_TOL_ULPS * cs.BF16_ULP * h.abs().clamp(min=1.0)
        for args in case["fused"]:
            got = kernels.fused_gru_update(h, x, *args)
            if exact:
                diff = (got - update.gru_update_plain(h, x, *args)).abs()
                if ((diff > allowed).any() or (diff > 0).float().mean()
                        > cs.UPDATE_DIFF_SHARE):
                    err = max(err, diff.max().item())
            ms = cs.time_ms(lambda: kernels.fused_gru_update(h, x, *args))
            times.append(f"along {args[-1]} {ms:.4f} ms")
    elif source == "update_tail":
        me = update.motion_encoder_params(case["ub"].encoder)
        c1, f1, fl = (update.nhwc(case[k]) for k in ("cor1", "flo1", "flow"))
        got = kernels.motion_encoder_tail(c1, f1, fl, *me).float()
        if exact:
            want = update.motion_encoder_tail_plain(c1, f1, fl, *me).float()
            diff = (got - want).abs()
            if ((diff > cs.BF16_ULP * (cs.TAIL_TOL_ULPS * want.abs()
                                       + want.abs().max())).any()
                    or (diff > 0).float().mean() > cs.UPDATE_DIFF_SHARE):
                err = diff.max().item()
        ms = cs.time_ms(lambda: kernels.motion_encoder_tail(c1, f1, fl, *me))
        times.append(f"{ms:.4f} ms")
    else:
        fh = case["head"]
        got = kernels.flow_head(h, *fh)
        if exact:
            want = update.flow_head_plain(h, *fh)
            diff = (got - want).abs()
            if diff.max() > cs.HEAD_TOL_ULPS * cs.BF16_ULP * want.abs().max():
                err = diff.max().item()
        ms = cs.time_ms(lambda: kernels.flow_head(h, *fh))
        times.append(f"{ms:.4f} ms")
    return err, ", ".join(times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default="ABCD",
                    help="letters of the kernels whose variants run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ablate: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from woft_tpu_torch.device import resolve_device
    from woft_tpu_torch.models import corr
    from woft_tpu_torch.ops import kernels, warp

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0])
    dev = resolve_device("cuda")
    entries = build_variants(kernels, args.kernels)
    letters = args.kernels
    if "A" in letters:
        frame = torch.tensor(cs.textured_frame(cs.H_IMG, cs.W_IMG, seed=3),
                             dtype=torch.float32, device=dev)[None]
        poses = {k: H.to(dev) for k, H in cs.warp_poses().items()}
    if "B" in letters:
        pyramid, coords, cells, c_cells = cs.lookup_case(corr, dev)
        want_b = corr.corr_lookup_plain(pyramid, coords, 4).reshape(
            coords.numel() // 2, -1)
    if "C" in letters:
        c_args, c_want = local_corr_case(corr, dev)
    if "D" in letters:
        g = torch.Generator(device=dev).manual_seed(7)
        local = corr.build_local_corr(
            torch.randn(1, 90, 160, 256, device=dev, generator=g),
            torch.randn(1, 90, 160, 256, device=dev, generator=g), 4, 4, 16,
            out_dtype=torch.bfloat16)
        d_coords = cs._local_coords(dev, "smooth")
        d_want = corr.block_local_lookup_coords_plain(local, d_coords, 9,
                                                      torch.bfloat16)[0]
    if set(letters) & set("GHI"):
        upd = cs.update_case(dev)
    for name, fns in entries.items():
        kernels._entries.update(fns)        # the wrappers launch this build
        exact = VARIANTS[name][2]
        source = VARIANTS[name][0]
        if source == "warp":
            cells_ms, err = [], 0.0
            for H in poses.values():
                hinv = warp.inverse_h(H[None])
                got = kernels.warp_perspective_bilinear(frame, hinv, cs.H_IMG,
                                                        cs.W_IMG)
                if exact:
                    err = max(err, (got - warp.warp_perspective(
                        frame, H)).abs().max().item())
                cells_ms.append(cs.time_ms(
                    lambda: kernels.warp_perspective_bilinear(
                        frame, hinv, cs.H_IMG, cs.W_IMG)))
            times = ", ".join(f"{k} {ms:.4f} ms"
                              for k, ms in zip(poses, cells_ms))
        elif source == "corr_lookup":
            got = kernels.corr_pyramid_lookup(pyramid, coords, 4)
            err = (got - want_b).abs().max().item() if exact else 0.0
            dense = cs.time_ms(lambda: kernels.corr_pyramid_lookup(
                pyramid, coords, 4))
            indexed = cs.time_ms(lambda: kernels.corr_pyramid_lookup(
                pyramid, c_cells, 4, rows=cells))
            times = f"dense {dense:.4f} ms, indexed {indexed:.4f} ms"
        elif source == "local_lookup":
            def lookup():
                return kernels.local_lookup_coords(
                    d_coords, local.volumes, local.consts["table"], 9,
                    torch.bfloat16)[0]
            got = lookup()
            err = (got.float() - d_want.float()).abs().max().item() \
                if exact else 0.0
            ms = cs.time_ms(lookup)
            times = f"bf16, 4 levels, one lookup {ms:.4f} ms"
        elif source in ("gru", "update_tail", "flow_head"):
            err, times = update_variant(kernels, cs, upd, source, exact)
        else:
            got = kernels.local_corr_build(*c_args, torch.bfloat16)
            err = 0.0
            if exact:
                for g, w in zip(got, c_want):
                    g, w = g.float(), w.float()
                    excess = (g - w).abs() - cs.CORR_RTOL_BF16 * w.abs()
                    if excess.max().item() > cs.CORR_ATOL:
                        err = (g - w).abs().max().item()
            ms = cs.time_ms(lambda: kernels.local_corr_build(
                *c_args, torch.bfloat16), iters=10)
            times = f"bf16, 4 levels, one launch {ms:.4f} ms"
        checked = f"max_abs_err {err:.3g}" if exact else "result not compared"
        if exact and source in ("local_corr", "gru", "update_tail",
                                "flow_head"):
            checked = ("within tolerance" if err == 0.0 else
                       f"beyond tolerance, max_abs_err {err:.3g}")
        print(f"{name}: {times} ({checked})", flush=True)
        if exact and err != 0.0:
            print(f"torch_kernel_ablate: '{name}' disagrees with the plain "
                  f"version", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
