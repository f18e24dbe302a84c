"""Last convs of 1 to 48 output channels on the CPU: the SESR paper's
Y-channel networks (Bhardwaj et al., MLSys 2022: one input channel, x2's 4
outputs before the shuffle, x3's 9), an RGB x3 (27) and an RGB x4 (48, the
widest output of an RGB SESR up to x4), and a Y denoiser of one output, at
SESR-M5's widths and depth (16 channels, 7 convs), from the JAX package's
seeded ``init_params``, calibrated by the JAX package on two seeded 24x32
images and carried across with ``convert.quantparams_from_fields``:

- the port's plain interpreter (reference, corrected, fast; with dumps) is
  array_equal with the JAX package's ``integer_forward``, and its K1 and
  K2 forwards on the CPU with the JAX package's K1 and K2 in interpret
  mode;
- ``certify_fast`` gives the JAX package's certificate field for field,
  and a copy with conv 3 and the last conv at +127 serves hybrid: its
  hybrid and corrected PE-exact forwards equal ``packed_hybrid_forward``
  and ``packed_exact_forward(corrected=True)``;
- ``convert.kernel_constants`` takes every count from 1 to 48 on all three
  datapaths, its parameter block decodes to the artifact's constants (the
  last conv's own rows past the hidden width), the corners still refused
  (quan_bits 9-16, width 48, 5x5 hidden convs, 5 input channels, 49
  outputs) are refused by name, and 17 and 2 convs are taken as layer
  groups;
- ``costs.conv_macs`` and chip_smoke.py's ``halo_ratio`` and ``bound`` of
  the networks chip_smoke.py phase 15 runs.

The kernels themselves are held against the plain version on the card by
chip_smoke.py phase 15. Each artifact is built once per file."""

import dataclasses
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sesr_tpu.config import SESRSpec as JSESRSpec
from sesr_tpu.models.sesr import init_params as jinit_params
from sesr_tpu.ops.packed import (packed_exact_forward, packed_hybrid_forward,
                                 select_packed_forward)
from sesr_tpu.ops.pallas_packed import build_pallas_packed_forward
from sesr_tpu.ops.pallas_pipeline import build_pallas_forward
from sesr_tpu.quant.calibrate import calibrate as jcalibrate
from sesr_tpu.quant.certify import certify_fast as jcertify_fast
from sesr_tpu.quant.integer import integer_forward as jinteger_forward
from sesr_tpu_torch import convert, costs, deploy
from sesr_tpu_torch.config import SESRSpec
from sesr_tpu_torch.ops.corrected import (hybrid_forward, pe_exact_corrected_forward,
                                          split_layers)
from sesr_tpu_torch.ops.fast import fast_forward
from sesr_tpu_torch.ops.kernels import NET_KERNELS
from sesr_tpu_torch.ops.pe_exact import pe_exact_forward
from sesr_tpu_torch.quant.certify import certify_fast
from sesr_tpu_torch.quant.integer import integer_forward
from tests.test_torch_deep import deepened
from tests.test_torch_params import _same
from tests.test_torch_params import one_torch_thread  # noqa: F401 (fixture)

# output count: (input channels, output channels, scale)
SHAPES = {1: (1, 1, 1), 4: (1, 1, 2), 9: (1, 1, 3), 27: (3, 3, 3), 48: (3, 3, 4)}
OUTS = tuple(SHAPES)
H, W = 24, 32
SATURATED = (3, 6)          # conv 3 and the last conv at +127: unstamped, served hybrid


def _net(oc):
    ic, out, scale = SHAPES[oc]
    return dict(name=f"sesr_m5_{oc}out", in_channels=ic, out_channels=out, num_channels=16,
                num_lblocks=5, scaling_factor=scale)


def _images(ic, n=2, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.random((1, H, W, ic), dtype=np.float32) for _ in range(n)]


def _carried(jqp):
    return convert.quantparams_from_fields({f.name: getattr(jqp, f.name)
                                            for f in dataclasses.fields(jqp)})


@functools.lru_cache(maxsize=None)
def _calibrated(oc):
    """(port spec, JAX spec, JAX QuantParams, the port's carried copy)."""
    jspec = JSESRSpec(**_net(oc))
    jqp = jcalibrate(jspec, jinit_params(jspec, jax.random.PRNGKey(0)),
                     _images(jspec.in_channels), safe_zero_floor=True)
    return SESRSpec(**_net(oc)), jspec, jqp, _carried(jqp)


@functools.lru_cache(maxsize=None)
def _certified(oc):
    """(port spec, JAX spec, JAX certified, the port's certified): each
    package certifies on one image."""
    spec, jspec, jqp, qp = _calibrated(oc)
    img = _images(spec.in_channels, 1, seed=1)
    return spec, jspec, jcertify_fast(jspec, jqp, img), certify_fast(spec, qp, img, device="cpu")


@functools.lru_cache(maxsize=None)
def _saturated(oc):
    """The network with convs SATURATED at +127, certified by the port: (spec,
    JAX spec, the JAX QuantParams with the port's stamps, the port's)."""
    spec, jspec, jqp, qp = _calibrated(oc)
    w = [np.full_like(np.asarray(a), 127) if i in SATURATED else np.asarray(a)
         for i, a in enumerate(qp.w_int)]
    sat = certify_fast(spec, dataclasses.replace(qp, w_int=w),
                       _images(spec.in_channels, 1, seed=1), device="cpu")
    jsat = dataclasses.replace(jqp, w_int=w, fast_cert_ok=sat.fast_cert_ok,
                               fast_cert_layers=sat.fast_cert_layers,
                               fast_cert_static=sat.fast_cert_static,
                               shortcut_static=sat.shortcut_static)
    return spec, jspec, jsat, sat


@pytest.mark.parametrize("oc", OUTS)
def test_interpreter_matches_jax(oc):
    """Output and every dump, reference and corrected, and the fast
    compute, array_equal with the JAX package's."""
    spec, jspec, jqp, qp = _certified(oc)
    assert spec.conv_out_channels == oc
    img = _images(spec.in_channels, 1, seed=2)[0]
    for corrected in (False, True):
        y, dumps = integer_forward(spec, qp, img, collect_dumps=True, corrected=corrected,
                                   device="cpu")
        jy, jdumps = jinteger_forward(jspec, jqp, jnp.asarray(img), collect_dumps=True,
                                      corrected=corrected, compute="int32")
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
        assert y.shape == (1, H * jspec.scaling_factor, W * jspec.scaling_factor,
                           jspec.out_channels)
        for key in [f"input.{i}" for i in range(spec.num_convs + 1)] + ["overflow_18"]:
            np.testing.assert_array_equal(np.asarray(dumps[key]), np.asarray(jdumps[key]),
                                          err_msg=f"{oc} {key} corrected={corrected}")
    yf = integer_forward(spec, qp, img, corrected=True, compute="fast", device="cpu")[0]
    jyf = jinteger_forward(jspec, jqp, jnp.asarray(img), corrected=True, compute="fast")[0]
    np.testing.assert_array_equal(yf.numpy(), np.asarray(jyf))


@pytest.mark.parametrize("oc", OUTS)
def test_plain_matches_jax_k1_and_k2(oc):
    """pe_exact_forward and fast_forward on the CPU (the kernels' plain
    versions) array_equal with the JAX package's K1 and K2 in interpret
    mode; each network certifies fully in both packages."""
    spec, jspec, jqp, qp = _certified(oc)
    assert qp.fast_cert_ok and jqp.fast_cert_ok
    x = _images(spec.in_channels, 1, seed=3)[0]
    k1 = build_pallas_forward(jspec, jqp, H, W, tile_h=16, tile_w=32, interpret=True)
    np.testing.assert_array_equal(pe_exact_forward(spec, qp, x, device="cpu").numpy(),
                                  np.asarray(k1(jnp.asarray(x))))
    k2 = build_pallas_packed_forward(jspec, jqp, H, W, tile_h=16, tile_w=16, interpret=True)
    np.testing.assert_array_equal(fast_forward(spec, qp, x, device="cpu").numpy(),
                                  np.asarray(k2(jnp.asarray(x))))


@pytest.mark.parametrize("oc", OUTS)
def test_certificate_and_mode_match_jax(oc):
    """The port's certificate equals the JAX package's field for field, and
    both pick the same mode; the carried artifact is the JAX one."""
    spec, jspec, jqp, qp = _certified(oc)
    _same(qp, jqp)
    _same(_calibrated(oc)[3], _calibrated(oc)[2])
    assert (qp.cert_grade, qp.cert_stamps) == (jqp.cert_grade, jqp.cert_stamps)
    assert deploy.select_forward(qp)[0] == select_packed_forward(jqp)[0] == "fast"


@pytest.mark.parametrize("oc", OUTS)
def test_hybrid_and_pe_exact_match_jax(oc):
    """With conv 3 and the last conv at +127 the certificate leaves them
    unstamped and both packages serve hybrid; the hybrid forward (f32 and
    int8) equals ``packed_hybrid_forward``, the corrected PE-exact forward
    ``packed_exact_forward(corrected=True)``, each splitting the last conv
    per PE."""
    spec, jspec, jsat, sat = _saturated(oc)
    L = spec.num_convs
    stamps = tuple(sat.fast_cert_layers)
    assert not any(stamps[i] for i in SATURATED) and any(stamps)
    assert deploy.select_forward(sat)[0] == select_packed_forward(jsat)[0] == "hybrid"
    assert split_layers(sat, "hybrid")[L - 1] and split_layers(sat, "pe-exact")[L - 1]
    x = _images(spec.in_channels, 1, seed=5)[0]
    for out_dtype in ("f32", "int8"):
        np.testing.assert_array_equal(
            hybrid_forward(spec, sat, x, out_dtype=out_dtype, device="cpu").numpy(),
            np.asarray(packed_hybrid_forward(jspec, jsat, jnp.asarray(x), out_dtype=out_dtype)))
        np.testing.assert_array_equal(
            pe_exact_corrected_forward(spec, sat, x, out_dtype=out_dtype, device="cpu").numpy(),
            np.asarray(packed_exact_forward(jspec, jsat, jnp.asarray(x), corrected=True,
                                            out_dtype=out_dtype)))


def _cut(spec, qp, oc):
    """spec and qp with the last conv cut to its first ``oc`` output
    channels and no pixel shuffle: a network of any count from one
    artifact."""
    L = spec.num_convs
    cut = dataclasses.replace(
        qp, w_int=[*qp.w_int[:L - 1], np.asarray(qp.w_int[L - 1])[..., :oc]],
        bias_int=[*qp.bias_int[:L - 1], np.asarray(qp.bias_int[L - 1])[:oc]],
        bias_f=[*qp.bias_f[:L - 1], np.asarray(qp.bias_f[L - 1])[:oc]])
    return dataclasses.replace(spec, name=f"cut{oc}", out_channels=oc, scaling_factor=1), cut


@pytest.mark.parametrize("datapath", ["exact", "fast", "corrected"])
def test_kernel_constants_take_every_count(datapath):
    """Every count from 1 to 48: the kernel's constants build (K1 and K2 in
    the shipped instantiation at 3, 12 and 16 only, the corrected kernel up
    to 16), each kernel has a tile, B is each layer's words with the last
    conv's out_columns (8, 16, 32 or 48) columns, and the parameter block
    decodes: its last record's "out" word is the count, and past the hidden
    width the last conv's bias, z_eff * sum(W) and per-PE rows follow the
    per-PE rows of the records (its "rows" word their offset), the block
    as long as the kernels read."""
    spec48, _, _, qp48 = _calibrated(48)
    kernel = {k.datapath: k for k in NET_KERNELS}[datapath]
    L = spec48.num_convs
    for oc in range(1, convert.MAX_OUT + 1):
        spec, qp = _cut(spec48, qp48, oc)
        split = (True,) * L if datapath == "corrected" else None
        kc = convert.kernel_constants(spec, qp, datapath, split)
        shipped = oc in convert.SHIPPED_OUT if datapath != "corrected" else oc <= 16
        assert kc.general or shipped, oc
        assert kc.out_channels == oc and kc.param("out", L - 1) == oc
        assert kc.params.shape == (convert.block_words(4, L, 16, oc),)
        assert kernel.tile(spec, kc.pe_split, 4, kc.general) in kernel.tiles
        cols = convert.out_columns(oc)
        assert cols == next(c for c in (8, 16, 32, 48) if oc <= c)
        w = convert._padded(np.asarray(qp.w_int[L - 1]), 16, oc)
        last = (convert._wgmma_b_words if datapath == "corrected"
                else convert._fragment_words)(w, kc.pe_split[L - 1], 4, True)
        np.testing.assert_array_equal(kc.weights[kc.param("w_off", L - 1):], last)
        if datapath == "corrected":            # 13 k32 steps, 4 PE groups of cols columns
            assert last.size * 4 == 13 * 4 * cols * 32
        else:
            passes, chunks, _ = convert.layer_geometry(5, 16, kc.pe_split[L - 1], 4)
            assert last.size == passes * chunks * 32 * 2 * (cols // 8)
        bias = (qp.fused_bias(L - 1) if datapath == "exact"
                else np.clip(qp.bias_int[L - 1], -32768, 32767))
        np.testing.assert_array_equal(kc.param("bias", L - 1)[:oc], bias)
        terms = convert.pe_zero_terms(qp, L - 1)
        for p in range(4):
            np.testing.assert_array_equal(kc.zc_pe(L - 1, p)[:oc],
                                          terms[p] if datapath == "corrected" else 0)
        np.testing.assert_array_equal(kc.param("zc", L - 1)[:oc],
                                      terms.sum(axis=0) if datapath == "fast" else 0)
        own = convert.param_words(4, L, 16)
        if oc > 16:
            assert kc.param("rows", L - 1) == own
            np.testing.assert_array_equal(kc.params[own:own + oc], kc.param("bias", L - 1))
            # the record's own bias and zero rows stay zero
            at = convert.param_at("bias", L - 1, 16)
            np.testing.assert_array_equal(kc.params[at:at + 32], 0)
        else:
            assert kc.param("rows", L - 1) == 0 and kc.params.size == own
    with pytest.raises(NotImplementedError, match="1-48 output"):
        spec, qp = _cut(spec48, qp48, 48)
        convert.kernel_constants(dataclasses.replace(spec, out_channels=49), qp, datapath,
                                 (True,) * L if datapath == "corrected" else None)


@pytest.mark.parametrize("bad", ["quan_bits=9", "quan_bits=16", "width=48", "width=80",
                                 "convs=17", "convs=2", "k_block=4", "in_channels=5", "out=49"])
def test_kernel_constants_refuse_what_is_left(bad):
    """The corners still to port are refused, each naming its limit. 17
    convs, refused until the layer-group form, is taken: every kernel plans
    it as two groups (convs 0-8 and 9-16) that fit a block and builds their
    constants. 2 convs (num_lblocks 0), refused until the two-conv group, is
    taken too: every kernel plans it as one group of both convs, flags
    GROUP_FIRST | GROUP_LAST, that fits a block. Conv sizes other than 5x5 /
    3x3 ... / 5x5 are taken (tests/test_torch_ksizes.py), but for an even
    size, refused with its own message. A hidden width of 48, refused until
    the width-64 instantiations, is taken: every kernel plans it at width
    64 in the forms of other conv sizes (tests/test_torch_wide.py); a width
    past 64 is refused."""
    spec, _, _, qp = _calibrated(4)
    if bad == "width=48":
        spec = dataclasses.replace(spec, num_channels=48)   # the weights padded to 64
        for datapath in convert.DATAPATHS:
            kc = convert.kernel_constants(spec, qp, datapath, (True,) * spec.num_convs
                                          if datapath == "corrected" else None)
            assert kc.width == 64 and kc.ksize_form and len(kc.groups) >= 1 and kc.general
            kern = {k.datapath: k for k in NET_KERNELS}[datapath]
            assert all(need <= 232448 for _, _, need in kern.launch_plans(spec, kc))
        return
    if bad in ("convs=17", "convs=2"):
        convs = int(bad[6:])
        qp = deepened(qp, convs)
        spec = dataclasses.replace(spec, num_lblocks=convs - 2)
        want = [(0, 8), (9, 16)] if convs == 17 else [(0, 1)]
        for datapath in convert.DATAPATHS:
            kc = convert.kernel_constants(spec, qp, datapath, (True,) * spec.num_convs
                                          if datapath == "corrected" else None)
            assert [(g.first, g.last) for g in kc.groups] == want and kc.general
            if convs == 2:
                assert kc.groups[0].flags == convert.GROUP_FIRST | convert.GROUP_LAST
            kern = {k.datapath: k for k in NET_KERNELS}[datapath]
            assert all(need <= 232448 for _, _, need in kern.launch_plans(spec, kc))
        return
    match = {"quan_bits=9": "quan_bits", "quan_bits=16": "quan_bits",
             "width=80": "widths of at most 64",
             "k_block=4": r"conv 1 of \S+ is 4x4 \(an even size", "in_channels=5": "1-4 input",
             "out=49": "1-48 output"}[bad]
    if bad.startswith("quan_bits"):
        qp = dataclasses.replace(qp, hw=dataclasses.replace(qp.hw, quan_bits=int(bad[10:])))
    else:
        field = {"width": "num_channels", "convs": "num_lblocks", "k_block": "k_block",
                 "in_channels": "in_channels", "out": "out_channels"}[bad.split("=")[0]]
        value = {"convs=17": 15}.get(bad, int(bad.split("=")[1]))
        spec = dataclasses.replace(spec, **{field: value}, scaling_factor=1)
    for datapath in convert.DATAPATHS:
        with pytest.raises(NotImplementedError, match=match):
            convert.kernel_constants(spec, qp, datapath, (True,) * spec.num_convs
                                     if datapath == "corrected" else None)


def _chip_smoke():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    module_spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def test_work_and_bounds_of_the_phase_15_networks():
    """MACs per input pixel of the networks chip_smoke.py phase 15 runs (by
    hand: 25 in 16 + 5 x 9 x 16 x 16 + 25 x 16 out at SESR-M5's widths, 25 in
    32 + 11 x 9 x 32 x 32 + 25 x 32 out at SESR-XL's), their bounds at
    1,979 int8 TOP/s on a frame whose output is 1080x1920 (chip_smoke.py
    ``bound``), and the MACs K1 and K2 compute over those needed at a 32x32
    tile (``halo_ratio``)."""
    smoke = _chip_smoke()
    nets = {name: SESRSpec(**kw) for name, kw in smoke.OUT_NETS.items()}
    hand = {"sesr_m5_x2_y": 25 * 16 + 5 * 9 * 256 + 25 * 16 * 4,
            "sesr_xl_x2_y": 25 * 32 + 11 * 9 * 1024 + 25 * 32 * 4,
            "sesr_m5_x3_rgb": 25 * 3 * 16 + 5 * 9 * 256 + 25 * 16 * 27,
            "sesr_m5_x4_rgb": 25 * 3 * 16 + 5 * 9 * 256 + 25 * 16 * 48,
            "sesr_xl_x4_rgb": 25 * 3 * 32 + 11 * 9 * 1024 + 25 * 32 * 48}
    assert {n: costs.conv_macs(s) for n, s in nets.items()} == hand == {
        "sesr_m5_x2_y": 13_520, "sesr_xl_x2_y": 105_376, "sesr_m5_x3_rgb": 23_520,
        "sesr_m5_x4_rgb": 31_920, "sesr_xl_x4_rgb": 142_176}
    frames = {n: smoke.out_frame(s) for n, s in nets.items()}
    assert frames == {"sesr_m5_x2_y": (540, 960), "sesr_xl_x2_y": (540, 960),
                      "sesr_m5_x3_rgb": (360, 640), "sesr_m5_x4_rgb": (270, 480),
                      "sesr_xl_x4_rgb": (270, 480)}
    for name, spec in nets.items():
        h, w = frames[name]
        assert (h * spec.scaling_factor, w * spec.scaling_factor) == (1080, 1920)
        ms, by = smoke.bound(2 * hand[name] * h * w, 0, smoke.INT8_OPS_PER_S)
        assert by == "operations" and ms == pytest.approx(2e3 * hand[name] * h * w / 1.979e15)
    assert round(smoke.halo_ratio(nets["sesr_m5_x4_rgb"], (32, 32)), 3) == round(
        sum((32 + 2 * r) ** 2 * m for r, m in ((7, 1200), (6, 2304), (5, 2304), (4, 2304),
                                               (3, 2304), (2, 2304), (0, 19200)))
        / (32 * 32 * 31_920), 3)
