"""The SESR paper's deepest and widest members (Bhardwaj et al., MLSys
2022) on the CPU: SESR-M11 x2 (13 convs, 16 channels) and SESR-XL x2 (13
convs, 32 channels), from the JAX package's seeded ``init_params``,
calibrated by the JAX package on two seeded 24x32 images and carried
across with ``convert.quantparams_from_fields``:

- the port's plain interpreter (reference, corrected, fast; with dumps) is
  array_equal with the JAX package's ``integer_forward`` and with its K1
  and K2 in interpret mode, through the port's ``pe_exact_forward`` and
  ``fast_forward``;
- ``certify_fast`` stamps as the JAX package's does, and
  ``deploy.select_forward`` picks the mode ``select_packed_forward`` picks;
- an M11 and an XL with convs SATURATED at +127 are left partly unstamped
  and served hybrid; their hybrid and corrected PE-exact forwards equal
  the JAX package's;
- ``convert.kernel_constants`` takes both networks for K1, K2 and the
  corrected kernel (in both of its modes), its parameter block decodes to
  the artifact's per-layer constants at every conv, and it takes 17
  convs in groups and refuses a width of 80 with its own message; XL with every conv
  split takes the corrected kernel's constants and a K1 tile at every PE
  count from 1 to 8;
- ``costs.conv_macs`` and chip_smoke.py's ``halo_ratio``;
- chip_smoke.py's ``launch_attrs`` reads only a kernel launched in the
  trace it reads, and takes a trace that misses it again.

The kernels themselves are held against the plain version on the card by
chip_smoke.py phase 14. Each artifact is built once (the JAX package's
``certify_fast`` takes 13-27 s per artifact here)."""

import contextlib
import dataclasses
import functools
import importlib.util
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesr_tpu.config import SESRSpec as JSESRSpec
from sesr_tpu.models.sesr import init_params as jinit_params
from sesr_tpu.ops.packed import packed_hybrid_forward, select_packed_forward
from sesr_tpu.ops.pallas_packed import build_pallas_packed_forward
from sesr_tpu.ops.pallas_pipeline import build_pallas_forward
from sesr_tpu.quant.calibrate import calibrate as jcalibrate
from sesr_tpu.quant.certify import certify_fast as jcertify_fast
from sesr_tpu.quant.integer import integer_forward as jinteger_forward
from sesr_tpu_torch import convert, costs, deploy
from sesr_tpu_torch.config import SESRSpec, spec_for_task
from sesr_tpu_torch.ops.corrected import (hybrid_forward, pe_exact_corrected_forward,
                                          split_layers)
from sesr_tpu_torch.ops.fast import fast_forward
from sesr_tpu_torch.ops.kernels import pe_exact_net
from sesr_tpu_torch.ops.pe_exact import pe_exact_forward
from sesr_tpu_torch.quant.certify import certify_fast
from sesr_tpu_torch.quant.integer import integer_forward
from tests.test_torch_deep import deepened
from tests.test_torch_params import _same
from tests.test_torch_params import one_torch_thread  # noqa: F401 (fixture)

NETS = {"m11": dict(name="sesr_m11_x2", in_channels=3, out_channels=3, num_channels=16,
                    num_lblocks=11, scaling_factor=2),
        "xl": dict(name="sesr_xl_x2", in_channels=3, out_channels=3, num_channels=32,
                   num_lblocks=11, scaling_factor=2)}
H, W = 24, 32
SATURATED = (3, 9)          # chip_smoke.py phase 14's unstamped M11


def _images(n=2, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.random((1, H, W, 3), dtype=np.float32) for _ in range(n)]


def _carried(jqp):
    return convert.quantparams_from_fields({f.name: getattr(jqp, f.name)
                                            for f in dataclasses.fields(jqp)})


@functools.lru_cache(maxsize=None)
def _calibrated(net):
    """(port spec, JAX spec, JAX QuantParams, the port's carried copy),
    calibrated by the JAX package, uncertified."""
    jspec = JSESRSpec(**NETS[net])
    jqp = jcalibrate(jspec, jinit_params(jspec, jax.random.PRNGKey(0)), _images(),
                     safe_zero_floor=True)
    return SESRSpec(**NETS[net]), jspec, jqp, _carried(jqp)


@functools.lru_cache(maxsize=None)
def _certified(net):
    """(port spec, JAX spec, JAX certified, the port's certified): each
    package certifies on one image."""
    spec, jspec, jqp, qp = _calibrated(net)
    return (spec, jspec, jcertify_fast(jspec, jqp, _images(1, seed=1)),
            certify_fast(spec, qp, _images(1, seed=1), device="cpu"))


@functools.lru_cache(maxsize=None)
def _saturated(net="m11"):
    """The network with convs SATURATED at +127, certified by the port:
    (spec, JAX spec, the JAX QuantParams with the port's stamps, the
    port's)."""
    spec, jspec, jqp, qp = _calibrated(net)
    w = [np.full_like(np.asarray(a), 127) if i in SATURATED else np.asarray(a)
         for i, a in enumerate(qp.w_int)]
    sat = certify_fast(spec, dataclasses.replace(qp, w_int=w), _images(1, seed=1), device="cpu")
    jsat = dataclasses.replace(jqp, w_int=w,
                               fast_cert_ok=sat.fast_cert_ok,
                               fast_cert_layers=sat.fast_cert_layers,
                               fast_cert_static=sat.fast_cert_static,
                               shortcut_static=sat.shortcut_static)
    return spec, jspec, jsat, sat


@pytest.mark.parametrize("net", list(NETS))
def test_interpreter_matches_jax(net):
    """The plain interpreter's output and every dump, reference and
    corrected, array_equal with the JAX package's; and the fast compute."""
    spec, jspec, jqp, qp = _certified(net)
    img = _images(1, seed=2)[0]
    for corrected in (False, True):
        y, dumps = integer_forward(spec, qp, img, collect_dumps=True, corrected=corrected,
                                   device="cpu")
        jy, jdumps = jinteger_forward(jspec, jqp, jnp.asarray(img), collect_dumps=True,
                                      corrected=corrected, compute="int32")
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
        for key in (f"input.{i}" for i in range(spec.num_convs + 1)):
            np.testing.assert_array_equal(np.asarray(dumps[key]), np.asarray(jdumps[key]),
                                          err_msg=f"{net} {key} corrected={corrected}")
    yf = integer_forward(spec, qp, img, corrected=True, compute="fast", device="cpu")[0]
    jyf = jinteger_forward(jspec, jqp, jnp.asarray(img), corrected=True, compute="fast")[0]
    np.testing.assert_array_equal(yf.numpy(), np.asarray(jyf))


@pytest.mark.parametrize("net", list(NETS))
def test_plain_matches_jax_k1_and_k2(net):
    """pe_exact_forward and fast_forward on the CPU (the kernels' plain
    versions) array_equal with the JAX package's K1 and K2 in interpret
    mode."""
    spec, jspec, jqp, qp = _certified(net)
    assert qp.fast_cert_ok and jqp.fast_cert_ok
    x = _images(1, seed=3)[0]
    k1 = build_pallas_forward(jspec, jqp, H, W, tile_h=16, tile_w=32, interpret=True)
    np.testing.assert_array_equal(pe_exact_forward(spec, qp, x, device="cpu").numpy(),
                                  np.asarray(k1(jnp.asarray(x))))
    k2 = build_pallas_packed_forward(jspec, jqp, H, W, tile_h=16, tile_w=16, interpret=True)
    np.testing.assert_array_equal(fast_forward(spec, qp, x, device="cpu").numpy(),
                                  np.asarray(k2(jnp.asarray(x))))


@pytest.mark.parametrize("net", list(NETS))
def test_certify_and_select_match_jax(net):
    spec, jspec, jqp, qp = _certified(net)
    _same(qp, jqp)
    assert (qp.cert_grade, qp.cert_stamps) == (jqp.cert_grade, jqp.cert_stamps)
    assert qp.fast_cert_ok
    mode, fn = deploy.select_forward(qp)
    assert mode == select_packed_forward(jqp)[0] == "fast"
    x = _images(1, seed=4)[0]
    assert torch.equal(fn(spec, qp, x, device="cpu"),
                       integer_forward(spec, qp, x, corrected=True, device="cpu")[0])


@pytest.mark.parametrize("net", list(NETS))
def test_unstamped_m11_serves_hybrid_as_jax_does(net):
    """The saturated convs (and those their saturation reaches) are left
    unstamped, on M11 and on XL: the hybrid mode, each layer split where it
    is unstamped; the corrected PE-exact mode splits where the static proof
    cannot clear the 18-bit clamp. Both outputs equal the JAX package's."""
    spec, jspec, jsat, sat = _saturated(net)
    stamps = tuple(sat.fast_cert_layers)
    assert not any(stamps[i] for i in SATURATED) and any(stamps)
    assert deploy.select_forward(sat)[0] == select_packed_forward(jsat)[0] == "hybrid"
    assert split_layers(sat, "hybrid") == tuple(not s for s in stamps)
    assert any(split_layers(sat, "pe-exact"))
    x = _images(1, seed=5)[0]
    for out_dtype in ("f32", "int8"):
        np.testing.assert_array_equal(
            hybrid_forward(spec, sat, x, out_dtype=out_dtype, device="cpu").numpy(),
            np.asarray(packed_hybrid_forward(jspec, jsat, jnp.asarray(x), out_dtype=out_dtype)))
    np.testing.assert_array_equal(
        pe_exact_corrected_forward(spec, sat, x, device="cpu").numpy(),
        np.asarray(jinteger_forward(jspec, jsat, jnp.asarray(x), corrected=True)[0]))


def _decoded(kc, qp, i):
    """What conv i's record must hold (convert.kernel_constants)."""
    z = qp.effective_zero(i)
    m_f, p_f = convert.requant_factors(qp.requant_m[i], qp.requant_n[i])
    return z, np.float32(qp.a_zero[i]), np.float32(m_f), np.float32(p_f)


@pytest.mark.parametrize("datapath", ["exact", "fast", "corrected"])
@pytest.mark.parametrize("net", list(NETS))
def test_kernel_constants_take_the_family(net, datapath):
    """K1 and K2 take both networks, the corrected kernel both in both of
    its modes (the saturated artifact's hybrid mask, and every conv split).
    The parameter block decodes to each conv's constants at every layer
    0..12, the weights are every layer's B fragments (K1, K2) or B (the
    corrected kernel: at width 32 two planes a k32 step, 32 columns a PE
    group) in order, and the block is as long as the kernels read."""
    spec, _, _, qp = _certified(net)
    L = spec.num_convs
    width = convert.kernel_width(spec.num_channels)
    splits = ([split_layers(_saturated(net)[3], "hybrid"), (True,) * L]
              if datapath == "corrected" else [None])
    for split in splits:
        cqp = _saturated(net)[3] if datapath == "corrected" else qp
        kc = convert.kernel_constants(spec, cqp, datapath, split)
        assert (kc.num_layers, kc.width, kc.pe) == (L, width, 4)
        assert kc.params.shape == (convert.param_words(4, L, width),)
        offsets = [int(kc.param("w_off", i)) for i in range(L)] + [kc.weights.size]
        for i in range(L):
            z, z_in, m_f, p_f = _decoded(kc, cqp, i)
            assert kc.param("z_eff", i) == z
            assert kc.param("z_in", i).view(np.float32) == z_in
            assert kc.param("rq_m", i).view(np.float32) == m_f
            assert kc.param("rq_p", i).view(np.float32) == p_f
            w = np.asarray(cqp.w_int[i])
            oc = w.shape[3]
            bias = kc.param("bias", i)
            if datapath == "exact":
                np.testing.assert_array_equal(bias[:oc], cqp.fused_bias(i))
            else:
                np.testing.assert_array_equal(bias[:oc], np.clip(cqp.bias_int[i], -32768, 32767))
            np.testing.assert_array_equal(bias[oc:], 0)
            kic = spec.in_channels if i == 0 else width
            koc = spec.conv_out_channels if i == L - 1 else width
            padded = convert._padded(w, kic, koc)
            words = (convert._wgmma_b_words if datapath == "corrected"
                     else convert._fragment_words)(padded, kc.pe_split[i], 4, i == L - 1)
            np.testing.assert_array_equal(kc.weights[offsets[i]:offsets[i + 1]], words)
        assert kc.param("pe_split") == sum(1 << i for i in range(L) if kc.pe_split[i])
        assert kc.param("clamp20") == sum(1 << i for i in range(L) if kc.clamp20[i])


def test_kernel_constants_refuse_past_the_limits():
    """A hidden width of 80 is refused with its own message; 17 convs run
    in two layer groups; XL with every conv split runs in the corrected
    kernel and in K1 at every PE count from 1 to 8."""
    spec, _, _, qp = _calibrated("m11")
    kc = convert.kernel_constants(dataclasses.replace(spec, num_lblocks=15), deepened(qp, 17),
                                  "fast")
    assert [(g.first, g.last) for g in kc.groups] == [(0, 8), (9, 16)]
    with pytest.raises(NotImplementedError, match="widths of at most 64"):
        convert.kernel_constants(dataclasses.replace(spec, num_channels=80), qp, "exact")
    # 16 convs are taken
    assert convert.MAX_LAYERS == 16 and convert.WIDTHS == (16, 32, 64)
    xl, _, _, xqp = _calibrated("xl")
    L = xl.num_convs
    tiles = {}
    for pe in range(1, 9):
        pqp = dataclasses.replace(xqp, hw=dataclasses.replace(xqp.hw, pe=pe))
        # the corrected kernel: B staged a layer at a time, every layer's B
        # in its PE groups (256 columns a hidden layer past four PEs)
        kc = convert.kernel_constants(xl, pqp, "corrected", (True,) * L)
        assert (kc.width, kc.pe, kc.pe_split) == (32, pe, (True,) * L)
        assert kc.general or pe == 4
        assert kc.params.shape == (convert.param_words(pe, L, 32),)
        assert kc.weights.size * 4 == sum(
            s * n * 32 for s, _, n in (convert.wgmma_geometry(
                k, 3 if i == 0 else 32, 12 if i == L - 1 else 32, True, i == L - 1, pe)
                for i, k in enumerate(xl.kernel_sizes)))
        # K1's general instantiation with every conv split: a tile at every
        # PE count (one weight buffer where two do not fit a block at the
        # tile, the next layer's B staged after each layer; at 8 PEs each
        # pass reads its PE's words only, so B is a quarter of the masked
        # passes' and 24x24 fits), and with none split 24x32 (one buffer;
        # two fit at 24x24)
        tiles[pe] = pe_exact_net.tile(xl, (True,) * L, pe, True)
        assert min(tiles[pe]) >= 16
        assert pe_exact_net.tile(xl, (False,) * L, pe, True) == (24, 32)
    assert tiles == {1: (24, 32), 2: (24, 24), 3: (24, 24), 4: (24, 32), 5: (16, 24),
                     6: (16, 24), 7: (16, 16), 8: (24, 24)}
    assert pe_exact_net.tile(xl, (True,) * L, 4) == (24, 24)
    # XL at 8 PEs with 12-bit accumulators, every conv split: K1 takes it, and
    # K2 (one pass a conv) too
    narrow = dataclasses.replace(xqp, hw=dataclasses.replace(xqp.hw, pe=8, pe_acc_bits=12))
    assert convert.pe_split_layers(narrow) == (True,) * L
    kc = convert.kernel_constants(xl, narrow, "exact")
    assert kc.general and kc.pe_split == (True,) * L and kc.width == 32
    assert pe_exact_net.tile(xl, kc.pe_split, 8, True) == (24, 24)
    assert convert.kernel_constants(xl, narrow, "fast").pe == 8


def _chip_smoke():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    module_spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def test_work_and_halo():
    """MACs per input pixel (the bounds of chip_smoke.py phase 14 at
    540x960: 16.42 and 59.40 us at 1,979 int8 TOP/s) and the MACs K1 and K2
    compute over those the network needs at their tiles."""
    m11, xl = SESRSpec(**NETS["m11"]), SESRSpec(**NETS["xl"])
    assert (costs.conv_macs(spec_for_task("sr_x2")), costs.conv_macs(m11),
            costs.conv_macs(xl)) == (12_912, 31_344, 113_376)
    halo_ratio = _chip_smoke().halo_ratio
    got = [round(halo_ratio(s, t), 2) for s, t in ((spec_for_task("sr_x2"), (32, 32)),
                                                   (m11, (32, 32)), (xl, (24, 24)),
                                                   (xl, (16, 16)))]
    assert got == [1.29, 1.98, 2.48, 3.51]


class _Trace:
    """A stand-in for ``torch`` whose profiler writes the given chrome
    traces in turn, one per ``profile`` block."""

    def __init__(self, traces):
        self.traces = list(traces)
        self.cuda = types.SimpleNamespace(synchronize=lambda: None)
        self.profiler = types.SimpleNamespace(
            ProfilerActivity=types.SimpleNamespace(CPU="cpu", CUDA="cuda"),
            profile=self._profile)

    @contextlib.contextmanager
    def _profile(self, activities):
        events = self.traces.pop(0)

        def export_chrome_trace(path):
            with open(path, "w") as f:
                json.dump({"traceEvents": events}, f)
        yield types.SimpleNamespace(export_chrome_trace=export_chrome_trace)


def _launch(corr):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernelExC", "args": {"correlation": corr}}


def _kernel(corr, ts, smem):
    return {"cat": "kernel", "name": "void sesr_net_kernel<0, 12, true, 16>", "ts": ts,
            "args": {"correlation": corr, "registers per thread": 128, "shared memory": smem}}


def test_launch_attrs_reads_this_trace_only(tmp_path, monkeypatch):
    """A kernel carried over from an earlier trace (its launch call is not
    in this one) is never read, even when it is the last; a trace that
    holds no launch of its own is taken again, up to ``tries`` times."""
    smoke = _chip_smoke()
    monkeypatch.setattr(smoke, "REPO", str(tmp_path))
    stale = _kernel(3, 900, 999)
    traces = [[_launch(7), _kernel(7, 100, 1000), stale],
              [_launch(8), stale],
              [_launch(9), _kernel(9, 200, 2000), stale]]
    fns = {"a": lambda: None, "b": lambda: None}
    assert smoke.launch_attrs(_Trace(traces), fns, tries=3) == {"a": (128, 1000),
                                                                "b": (128, 2000)}
    assert smoke.launch_attrs(_Trace(traces[:2]), fns) == {"a": (128, 1000),
                                                           "b": (None, None)}
