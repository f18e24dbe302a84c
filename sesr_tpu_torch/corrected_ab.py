"""python -m sesr_tpu_torch.corrected_ab [--base DIR] [--variants NAMES [--tiles TILES]] [--one-group] [--reps R]

An A/B of the corrected kernel (``sesr_corrected_net``) on the card: device
time per 1080x1920 frame at batch 1 (CUDA events, the device kept busy
while the host enqueues) on nr hybrid, nrdm_6 hybrid and nr pe-exact, the
inputs made from one numpy seed.

``--base DIR``: against another checkout of the repository, e.g. an
earlier commit unpacked with ``git archive <commit> | tar -x -C DIR`` into
a directory that .gitignore lists, on those three, on nr's artifact at 3
and at 8 PEs (the general instantiations at width 16), on K1 and K2
(``sesr_pe_exact_net``, ``sesr_fast_net``) on sr_x2's 540x960 frame, in
the shipped instantiation and in the general ones (sr_x2's artifact at 16
PEs, with wide sums at 16 PEs, at 6- and 4-bit activations: CONFIGS), on
SESR-M11 x2 with convs 3 and 9 at +127 in the hybrid and the PE-exact
mode at 540x960, and K1 on it and on SESR-XL x2 (the same convs at +127)
at 16 PEs, and the layer-group form (chains of two groups) on
chip_smoke.py phase 16's sesr_m16_x2 (convs 3 and 12 at +127: K1, K2 and
both corrected modes) and sesr_xl22_x2 (convs 3 and 18: K1 and the
PE-exact mode) (seeded weights calibrated and certified here on the card,
saved under build/corrected_ab/ and loaded by both trees). Each tree's
own wrappers and kernels run in their own process (``python -c`` from
the tree's root, which builds the tree's ``csrc/`` into its own
``build/``, every library at once), in turns base, this, this, base; each
prints its times, a digest of its int8 outputs and ptxas's registers and
spill stores of each network kernel family it built (PTXAS_FAMILIES: the
libraries the tree has), the digests of the two trees must agree, and each
instantiation of the base tree is compared with this tree's ptxas line
(``ptxas_equal``; ``new``: this tree's instantiations the base lacks).

``--variants NAMES``: against edited copies of ``csrc/sesr_corrected.cu``,
each with the text edits of VARIANTS, built side by side (one nvcc each,
all started together) into ``build/variants/corrected/<name>/`` and timed
in turns in this process, each output held against the plain version, at
the default tile or at each of ``--tiles`` (e.g. 32x64,32x48) that fits.
``no_epilogue`` and ``no_mma`` give a wrong output and say what the rest
costs; the others must be equal.

``--one-group``: each network that runs in one launch (ONE_GROUP_CASES:
K1 and K2 on sr_x2, the corrected kernel on nr, and all four on the
saturated SESR-M11 and SESR-XL x2) against the same network run as one
group of the layer-group form (``sesr_net_group``, ``sesr_corrected_group``:
the group kernels' instantiation with the group both first and last),
timed in turns one launch, one group, one group, one launch in this
process; the two outputs must be equal.

Needs the card and nvcc; prints one JSON line per measurement.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

VARIANT_DIR = Path(__file__).resolve().parent.parent / "build" / "variants" / "corrected"
# name: [(text, replacement)] in csrc/sesr_corrected.cu
VARIANTS = {
    "base": [],
    "warpgroups_3": [("constexpr int kWarpgroups = 4;", "constexpr int kWarpgroups = 3;")],
    "warpgroups_5": [("constexpr int kWarpgroups = 4;", "constexpr int kWarpgroups = 5;")],
    "no_epilogue": [("    f.epilogue(d, mt, carry, n);\n", "")],
    "no_mma": [("      wgmma<NC>(d, a_hi", "      if constexpr (false) wgmma<NC>(d, a_hi")],
}
FRAME = (1080, 1920)
CASES = (("nr", "hybrid"), ("nrdm_6", "hybrid"), ("nr", "pe-exact"))
# each network library's kernel families, whose ptxas reports --base
# prints and compares
PTXAS_FAMILIES = {
    "sesr_net": ("sesr_net_kernel", "sesr_net_wide_kernel"),
    "sesr_corrected": tuple(f"sesr_corrected{a}{form}_kernel" for a in ("", "_audit")
                            for form in ("", "_wide", "_wideout", "_pieces")),
    "sesr_net_group": ("sesr_net_group_kernel", "sesr_net_pair_kernel"),
    "sesr_corrected_group": ("sesr_corrected_group_kernel", "sesr_corrected_group_audit_kernel",
                             "sesr_corrected_tail_kernel", "sesr_corrected_tail_audit_kernel"),
    "sesr_net_ksize": ("sesr_net_ksize_kernel", "sesr_net_ksize_pair_kernel"),
    # the counting form of other conv sizes, in sesr_corrected_ksize's library
    # or in a library of its own (a tree has one or the other)
    "sesr_corrected_ksize": ("sesr_corrected_ksize_kernel", "sesr_corrected_ksize_audit_kernel"),
    "sesr_corrected_ksize_audit": ("sesr_corrected_ksize_audit_kernel",),
    "sesr_net_w64": ("sesr_net_ksize_kernel", "sesr_net_ksize_pair_kernel"),
    "sesr_corrected_w64": ("sesr_corrected_ksize_kernel",),
    "sesr_corrected_w64_audit": ("sesr_corrected_ksize_audit_kernel",)}
# --base only: the corrected kernel on nr's artifact at 3 and 8 PEs
# ("nr@pe3", "nr@pe8": its instantiations <4, true, 16> and <8, true, 16>)
# at 1080x1920, K1 and K2 on sr_x2, and the corrected kernel on the
# saturated SESR-M11 ("m11u"), at the 540x960 frame
TREE_CASES = CASES + (("nr@pe3", "pe-exact"), ("nr@pe8", "hybrid"), ("nr@pe8", "pe-exact"),
                      ("sr_x2", "K1"), ("sr_x2", "K2"), ("m11u", "hybrid"), ("m11u", "pe-exact"),
                      ("sr_x2@pe16", "K1"), ("sr_x2@pe16w", "K1"), ("sr_x2@pe16w", "K2"),
                      ("sr_x2@q6", "K1"), ("sr_x2@q6", "K2"), ("sr_x2@q4", "K1"),
                      ("nr@pe16", "K1"), ("m11u@pe16", "K1"), ("xlu@pe16", "K1"),
                      ("m16u", "K1"), ("m16u", "K2"), ("m16u", "hybrid"), ("m16u", "pe-exact"),
                      ("xl22u", "K1"), ("xl22u", "pe-exact"))
# task@config: the artifact's HardwareConfig fields replaced (the same
# weights and scales on another datapath)
CONFIGS = {"pe3": dict(pe=3), "pe8": dict(pe=8), "pe16": dict(pe=16),
           "pe16w": dict(pe=16, pe_acc_bits=20, pe_add_bits=24), "q6": dict(quan_bits=6),
           "q4": dict(quan_bits=4)}
SR_FRAME = (540, 960)
# the SESR paper's M11 x2 and XL x2 (chip_smoke.py phase 14's seeds), and
# phase 16's 18- and 24-conv networks (SESR-M11's and SESR-XL's widths),
# the convs named at +127: (spec, seed, convs at +127)
NETS = {"m11u": (dict(name="sesr_m11_x2", in_channels=3, out_channels=3, num_channels=16,
                      num_lblocks=11, scaling_factor=2), 0, (3, 9)),
        "xlu": (dict(name="sesr_xl_x2", in_channels=3, out_channels=3, num_channels=32,
                     num_lblocks=11, scaling_factor=2), 1, (3, 9)),
        "m16u": (dict(name="sesr_m16_x2", in_channels=3, out_channels=3, num_channels=16,
                      num_lblocks=16, scaling_factor=2), 16, (3, 12)),
        "xl22u": (dict(name="sesr_xl22_x2", in_channels=3, out_channels=3, num_channels=32,
                       num_lblocks=22, scaling_factor=2), 17, (3, 18))}
# --one-group: (network, kernel or corrected mode)
ONE_GROUP_CASES = (("sr_x2", "K1"), ("sr_x2", "K2"), ("nr", "hybrid"), ("nr", "pe-exact"),
                   *((net, m) for net in ("m11u", "xlu") for m in ("K1", "K2", "hybrid",
                                                                   "pe-exact")))

# Times this tree's network kernels: run with ``python -c`` from a tree's
# root, so that it imports that tree's package (whose wrapper API is
# kernel(spec, qp, x_q, split=...) in every version, split None but for the
# corrected kernel).
WORKER = r"""
import dataclasses, hashlib, json, sys
import numpy as np, torch
from sesr_tpu_torch.config import SESRSpec, spec_for_task
from sesr_tpu_torch.ops import _build
from sesr_tpu_torch.ops.corrected import split_layers
from sesr_tpu_torch.ops.kernels import corrected_net, fast_net, pe_exact_net
from sesr_tpu_torch.quant.integer import quantize_input
from sesr_tpu_torch.quant.params import QuantParams
from sesr_tpu_torch.timing import median_ms
reps, frames, cases, nets, configs = json.loads(sys.argv[1])
_build.build_all()
dev = torch.device("cuda")
out = {"device": torch.cuda.get_device_name(0)}
for task, mode in cases:
    name, _, config = task.partition("@")
    kw, path = nets.get(name, (None, f"artifacts/qparams_{name}.npz"))
    spec = SESRSpec(**kw) if kw else spec_for_task(name)
    qp = QuantParams.load(path)
    if config:
        qp = dataclasses.replace(qp, hw=dataclasses.replace(qp.hw, **configs[config]))
    if mode == "pe-exact":
        qp = dataclasses.replace(qp, fast_cert_layers=None)
    kern = {"K1": pe_exact_net, "K2": fast_net}.get(mode, corrected_net)
    split = split_layers(qp, mode) if kern is corrected_net else None
    x = torch.from_numpy(np.random.default_rng(0).random((1, *frames[task], 3),
                                                         dtype=np.float32)).to(dev)
    x_q = quantize_input(x, qp).to(torch.int8).contiguous()
    y = kern(spec, qp, x_q, split=split)
    ms = median_ms(lambda: kern(spec, qp, x_q, split=split), dev, reps, warmup=3, lead_ms=1.0)
    out[f"{task} {mode}"] = {"ms": ms,
                             "digest": hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16]}
out["build_logs"] = {lib: _build.build(lib).log for lib in PTXAS_FAMILIES
                     if lib in _build.SIGNATURES}
print(json.dumps(out))
""".replace("PTXAS_FAMILIES", repr(tuple(PTXAS_FAMILIES)))


def artifact(net: str) -> Path:
    """NETS[net] from seeded weights, calibrated on two seeded 96x128
    images, its convs named there at +127, certified on two more (the
    card's port), saved as a QuantParams file: built once, then reused."""
    import dataclasses

    import numpy as np
    import torch

    from sesr_tpu_torch.config import SESRSpec
    from sesr_tpu_torch.models.sesr import init_params
    from sesr_tpu_torch.quant.calibrate import calibrate
    from sesr_tpu_torch.quant.certify import certify_fast

    kw, seed, saturated = NETS[net]
    path = VARIANT_DIR.parent.parent / "corrected_ab" / f"{kw['name']}_saturated.npz"
    if not path.exists():
        spec = SESRSpec(**kw)
        rng = np.random.default_rng(14)
        images = [rng.random((1, 96, 128, 3), dtype=np.float32) for _ in range(4)]
        qp = calibrate(spec, init_params(spec, torch.Generator().manual_seed(seed)), images[:2],
                       safe_zero_floor=True, device="cuda")
        qp = dataclasses.replace(qp, w_int=[
            np.full_like(np.asarray(w), 127) if i in saturated else np.asarray(w)
            for i, w in enumerate(qp.w_int)])
        path.parent.mkdir(parents=True, exist_ok=True)
        certify_fast(spec, qp, images[2:], device="cuda").save(str(path))
    return path


def run_tree(tree: Path, reps: int) -> dict:
    from sesr_tpu_torch.ops import _build

    frames = {task: FRAME if task.partition("@")[0] in ("nr", "nrdm_6") else SR_FRAME
              for task, _ in TREE_CASES}
    nets = {net: (NETS[net][0], str(artifact(net))) for net in NETS}
    res = subprocess.run([sys.executable, "-c", WORKER,
                          json.dumps([reps, frames, TREE_CASES, nets, CONFIGS])],
                         cwd=tree, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"the worker in {tree} failed:\n{res.stderr[-4000:]}")
    out = json.loads(res.stdout.strip().splitlines()[-1])
    logs = out.pop("build_logs")
    out["ptxas"] = {f"{family}<{args}>": list(v) for lib, families in PTXAS_FAMILIES.items()
                    for family in families
                    for args, v in _build.ptxas_report(logs.get(lib, ""), family).items()}
    return out


def tree_ab(base: Path, reps: int) -> None:
    """base, this, this, base: each tree's kernel in its own process."""
    this = Path(__file__).resolve().parent.parent
    runs = []
    for label, tree in (("base", base), ("this", this), ("this", this), ("base", base)):
        r = run_tree(tree, reps)
        runs.append((label, r))
        print(json.dumps({"tree": label, "path": str(tree), **r}), flush=True)
    for t, m in TREE_CASES:
        key = f"{t} {m}"
        digests = {r[key]["digest"] for _, r in runs}
        if len(digests) != 1:
            raise SystemExit(f"{key}: the two trees' kernels give different outputs {digests}")
        ms = {lab: [r[key]["ms"] for lb, r in runs if lb == lab] for lab in ("base", "this")}
        print(json.dumps({"case": key, "base_ms": ms["base"], "this_ms": ms["this"],
                          "ratio": min(ms["this"]) / min(ms["base"]),
                          "outputs_equal": True}), flush=True)
    old, new = runs[0][1]["ptxas"], runs[1][1]["ptxas"]
    print(json.dumps({"ptxas_equal": all(new.get(k) == v for k, v in old.items()),
                      "instantiations": len(old),
                      "differ": {k: [v, new.get(k)] for k, v in old.items() if new.get(k) != v},
                      "new": sorted(set(new) - set(old))}), flush=True)


def build_variant(name: str) -> Path:
    from sesr_tpu_torch.ops import _build

    out = VARIANT_DIR / name
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "sesr_corrected.cu").read_text()
    for text, repl in VARIANTS[name]:
        if text not in src:
            raise ValueError(f"variant {name}: {text!r} is not in the source")
        src = src.replace(text, repl)
    (out / "sesr_corrected.cu").write_text(src)
    for header in _build.sources("sesr_corrected")[1:]:
        shutil.copy(header, out / header.name)
    lib = out / "libsesr_corrected.so"
    t0 = time.perf_counter()
    res = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                          str(out / "sesr_corrected.cu")], capture_output=True, text=True,
                         timeout=900)
    (out / "nvcc.log").write_text(res.stdout + res.stderr
                                  + f"\nnvcc seconds {time.perf_counter() - t0:.1f}\n")
    if res.returncode != 0:
        raise RuntimeError(f"variant {name}: nvcc failed\n{res.stderr[-4000:]}")
    return lib


def variant_ab(names, reps: int, tiles=None) -> None:
    import dataclasses

    import numpy as np
    import torch

    from sesr_tpu_torch.config import spec_for_task
    from sesr_tpu_torch.ops import _build
    from sesr_tpu_torch.ops.corrected import split_layers
    from sesr_tpu_torch.ops.kernels import SMEM_LIMIT, corrected_net
    from sesr_tpu_torch.quant.integer import integer_forward_int8, quantize_input
    from sesr_tpu_torch.quant.params import QuantParams
    from sesr_tpu_torch.timing import median_ms

    names = ["base"] + [n for n in names if n != "base"]
    with ThreadPoolExecutor(len(names)) as pool:
        paths = dict(zip(names, pool.map(build_variant, names)))
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        for symbol, argtypes in _build.SIGNATURES["sesr_corrected"].items():
            getattr(lib, symbol).argtypes = argtypes
            getattr(lib, symbol).restype = ctypes.c_int
        lib.sesr_corrected_error_string.argtypes = [ctypes.c_int]
        lib.sesr_corrected_error_string.restype = ctypes.c_char_p
        libs[name] = lib
        log = (path.parent / "nvcc.log").read_text()
        print(json.dumps({"variant": name,
                          "ptxas": {k: list(v) for k, v in _build.ptxas_report(
                              log, PTXAS_FAMILIES["sesr_corrected"]).items()},
                          "log": [ln.strip() for ln in log.splitlines()
                                  if "erialized" in ln or "nvcc sec" in ln]}), flush=True)
    load = _build.load
    dev = torch.device("cuda")
    x = torch.from_numpy(np.random.default_rng(0).random((1, *FRAME, 3), dtype=np.float32)).to(dev)
    try:
        for task, mode in CASES:
            spec = spec_for_task(task)
            qp = QuantParams.load(Path(__file__).resolve().parent.parent / "artifacts"
                                  / f"qparams_{task}.npz")
            if mode == "pe-exact":
                qp = dataclasses.replace(qp, fast_cert_layers=None)
            split = split_layers(qp, mode)
            x_q = quantize_input(x, qp).to(torch.int8).contiguous()
            plain = integer_forward_int8(spec, qp, x, corrected=True, compute="exact",
                                         fast_layers=tuple(qp.fast_cert_layers)
                                         if mode == "hybrid" else None)
            for tile in tiles or [corrected_net.tile(spec, split, qp.hw.pe)]:
                if corrected_net.smem_bytes(spec, tile, split, qp.hw.pe) > SMEM_LIMIT:
                    continue
                for name in names:
                    _build.load = lambda n, lib=libs[name]: lib if n == "sesr_corrected" \
                        else load(n)
                    y = corrected_net(spec, qp, x_q, split=split, tile=tile)
                    ms = median_ms(lambda: corrected_net(spec, qp, x_q, split=split, tile=tile),
                                   dev, reps, warmup=3, lead_ms=1.0)
                    print(json.dumps({"case": f"{task} {mode}", "variant": name,
                                      "tile": list(tile), "ms": ms,
                                      "equal_to_plain": bool(torch.equal(y, plain)),
                                      "device": torch.cuda.get_device_name(0)}), flush=True)
    finally:
        _build.load = load


def one_group_ab(reps: int) -> None:
    """ONE_GROUP_CASES: the one launch against one group (see the module
    docstring)."""
    import dataclasses

    import numpy as np
    import torch

    from sesr_tpu_torch.config import SESRSpec, spec_for_task
    from sesr_tpu_torch.convert import device_constants, group_constants
    from sesr_tpu_torch.ops.corrected import split_layers
    from sesr_tpu_torch.ops.kernels import corrected_net, fast_net, pe_exact_net
    from sesr_tpu_torch.quant.integer import quantize_input
    from sesr_tpu_torch.quant.params import QuantParams
    from sesr_tpu_torch.timing import median_ms

    dev = torch.device("cuda")
    root = Path(__file__).resolve().parent.parent
    for net, mode in ONE_GROUP_CASES:
        spec = SESRSpec(**NETS[net][0]) if net in NETS else spec_for_task(net)
        qp = QuantParams.load(str(artifact(net) if net in NETS
                                  else root / "artifacts" / f"qparams_{net}.npz"))
        if mode == "pe-exact":
            qp = dataclasses.replace(qp, fast_cert_layers=None)
        kern = {"K1": pe_exact_net, "K2": fast_net}.get(mode, corrected_net)
        split = split_layers(qp, mode) if kern is corrected_net else None
        frame = FRAME if net in ("nr", "nrdm_6") else SR_FRAME
        x = torch.from_numpy(np.random.default_rng(0).random((1, *frame, 3),
                                                             dtype=np.float32)).to(dev)
        x_q = quantize_input(x, qp).to(torch.int8).contiguous()
        kc, weights, _ = device_constants(spec, qp, kern.datapath, dev, split)
        if kc.groups:
            raise SystemExit(f"{net} {mode}: runs in {len(kc.groups)} groups, not one launch")
        # the constants kernel_constants gives a group: the general
        # instantiation, every sum clamped to pe_add_bits
        L, clamp = kc.num_layers, (True,) * kc.num_layers
        group = group_constants(kc.params, L, kc.width, kc.pe, kc.out_channels, kc.pe_split,
                                clamp, 0, L - 1)
        one = dataclasses.replace(kc, general=True, clamp20=clamp, groups=(group,))
        params = (torch.as_tensor(group.params, device=dev),)
        plans = kern.launch_plans(spec, one)

        def launch():
            return kern(spec, qp, x_q, split=split)

        def grouped():
            return kern._chain(one, weights, params, x_q, plans, None)[0]

        equal = bool(torch.equal(launch(), grouped()))
        ms = {"one launch": [], "one group": []}
        for label, fn in (("one launch", launch), ("one group", grouped),
                          ("one group", grouped), ("one launch", launch)):
            ms[label].append(median_ms(fn, dev, reps, warmup=3, lead_ms=1.0))
        print(json.dumps({"case": f"{net} {mode}", "convs": L, "pe": kc.pe,
                          "split": [i for i, f in enumerate(kc.pe_split) if f],
                          "one_launch_tile": list(kern.launch_plans(spec, kc)[0][1]),
                          "one_group_tile": list(plans[0][1]),
                          "one_launch_ms": ms["one launch"], "one_group_ms": ms["one group"],
                          "ratio": min(ms["one group"]) / min(ms["one launch"]),
                          "outputs_equal": equal,
                          "device": torch.cuda.get_device_name(0)}), flush=True)
        if not equal:
            raise SystemExit(f"{net} {mode}: one group's output differs from one launch's")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[1])
    ap.add_argument("--base", type=Path, help="another checkout to A/B against")
    ap.add_argument("--variants", help=f"comma-separated names of {sorted(VARIANTS)}")
    ap.add_argument("--tiles", help="comma-separated tiles, e.g. 32x64,32x48 (--variants)")
    ap.add_argument("--one-group", action="store_true",
                    help="one launch against one group of the layer-group form")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    if args.base is None and args.variants is None and not args.one_group:
        ap.error("give --base, --variants, --one-group or several")
    if args.base is not None:
        tree_ab(args.base.resolve(), args.reps)
    if args.variants is not None:
        names = args.variants.split(",")
        unknown = set(names) - set(VARIANTS)
        if unknown:
            ap.error(f"unknown variants {sorted(unknown)}")
        tiles = args.tiles and [tuple(int(v) for v in t.split("x")) for t in args.tiles.split(",")]
        variant_ab(names, args.reps, tiles)
    if args.one_group:
        one_group_ab(args.reps)


if __name__ == "__main__":
    main()
