"""The three fused kernels' Python side: their plain paths against the JAX
package's Pallas kernels (interpret mode, as tests/test_pallas.py and
tests/test_packed_pallas.py run them) and, for the corrected kernel, its
XLA hybrid and corrected PE-exact forwards, the weights carried across by
sesr_tpu_torch/convert.py, the kernels' packed constants, and the
wrappers' device rule: a CPU tensor takes the plain path and builds
nothing; any other device never falls back to it. The kernels themselves
are held against their plain versions on the card by chip_smoke.py."""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesr_tpu.config import spec_for_task as jspec_for_task
from sesr_tpu.ops.packed import (packed_exact_forward, packed_hybrid_forward,
                                 select_packed_forward)
from sesr_tpu.ops.pallas_packed import build_pallas_packed_forward
from sesr_tpu.ops.pallas_pipeline import build_pallas_forward
from sesr_tpu.quant.params import QuantParams as JQuantParams
from sesr_tpu_torch import convert, deploy
from sesr_tpu_torch.config import spec_for_task
from sesr_tpu_torch.ops import _build, corrected, fixedpoint, kernels
from sesr_tpu_torch.ops.fast import fast_forward
from sesr_tpu_torch.ops.kernels import OUT_DTYPES
from sesr_tpu_torch.ops.pe_exact import pe_exact_forward
from sesr_tpu_torch.quant.integer import integer_forward
from sesr_tpu_torch.quant.params import QuantParams
from tests.test_torch_deep import deepened
from tests.test_integer_bitexact import _golden_qparams, _load_golden
from tests.test_torch_params import ARTIFACTS, SIM_GOLDENS, _same
from tests.test_torch_params import one_torch_thread  # noqa: F401 (fixture)

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "artifacts")


def _carry(jqp):
    fields = {f.name: getattr(jqp, f.name) for f in dataclasses.fields(jqp)}
    return convert.quantparams_from_fields(fields)


def _artifact(task):
    path = os.path.join(ARTIFACT_DIR, f"qparams_{task}.npz")
    return QuantParams.load(path), JQuantParams.load(path)


@pytest.mark.parametrize("task,hw", [("sr_x2", (40, 72)), ("sr_x4", (40, 72)),
                                     ("nrdm_3", (40, 72)), ("nrdm_3", (27, 45))])
def test_pe_exact_plain_matches_pallas(task, hw):
    g = _load_golden(task)
    jspec, _, jqp = _golden_qparams(task, g)
    x = np.random.default_rng(1234).random((1,) + hw + (jspec.in_channels,),
                                           dtype=np.float32)
    want = build_pallas_forward(jspec, jqp, *hw, tile_h=16, tile_w=32,
                                interpret=True)(jnp.asarray(x))
    got = pe_exact_forward(spec_for_task(task), _carry(jqp), x, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("task,batch,hw", [("sr_x2", 1, (40, 72)),
                                           ("sr_x4", 1, (40, 72)),
                                           ("sr_x2", 3, (32, 48))])
def test_fast_plain_matches_pallas(task, batch, hw):
    qp, jqp = _artifact(task)
    spec = spec_for_task(task)
    x = np.random.default_rng(11).random((batch,) + hw + (spec.in_channels,),
                                         dtype=np.float32)
    want = build_pallas_packed_forward(jspec_for_task(task), jqp, *hw, tile_h=16,
                                       tile_w=24, batch=batch,
                                       interpret=True)(jnp.asarray(x))
    got = fast_forward(spec, qp, torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the int8 contract: the raw quantized image, dequantized by the consumer
    q = fast_forward(spec, qp, torch.from_numpy(x), out_dtype="int8")
    assert q.dtype == torch.int8 and q.shape == got.shape
    L = spec.num_convs
    deq = (q.numpy().astype(np.float32) - np.float32(qp.a_zero[L])) \
        * np.float32(qp.a_scale[L])
    np.testing.assert_array_equal(deq, np.asarray(want))


def test_fast_refuses_uncertified():
    qp, _ = _artifact("sr_x2")
    bad = dataclasses.replace(qp, fast_cert_ok=False)
    with pytest.raises(ValueError, match="certified"):
        fast_forward(spec_for_task("sr_x2"), bad, np.zeros((1, 8, 8, 3), np.float32),
                     device="cpu")


@pytest.mark.parametrize("path", ARTIFACTS, ids=os.path.basename)
def test_convert_carries_jax_quantparams(path):
    jqp = JQuantParams.load(path)
    _same(_carry(jqp), QuantParams.load(path))


def test_convert_carries_golden_quantparams():
    _, _, jqp = _golden_qparams("sr_x2", _load_golden("sr_x2"))
    qp = _carry(jqp)
    _same(qp, jqp)
    hw = {f.name: getattr(jqp.hw, f.name) for f in dataclasses.fields(jqp.hw)}
    fields = {f.name: getattr(jqp, f.name) for f in dataclasses.fields(jqp)}
    _same(convert.quantparams_from_fields({**fields, "hw": hw}), jqp)


def _unpack(words):
    """int32 words -> (..., 4) signed bytes."""
    return np.ascontiguousarray(words, np.int32).view(np.int8).reshape(words.shape + (4,))


@pytest.mark.parametrize("exact", [True, False])
def test_kernel_constants_layout(exact):
    """Every weight of every layer sits once in the B fragments, in the byte
    where the activation word holds its input channel, at the k-slot and
    column where the kernel's MMA meets that tap and output channel (lane
    4g + t, reg s: k-slot word t + 4s, column g); padded taps and channels
    are zero; a per-PE pass holds only its PE's channels."""
    task = "sr_x2"
    spec, (qp, _) = spec_for_task(task), _artifact(task)
    kc = convert.kernel_constants(spec, qp, "exact" if exact else "fast")
    L = spec.num_convs
    assert kc.params.shape == (convert.param_words(qp.hw.pe, L),)
    assert (kc.num_layers, kc.in_channels, kc.out_channels) == (5, 3, 12)
    offsets = [kc.param("w_off", i) for i in range(5)] + [kc.weights.size]
    for i, w in enumerate(qp.w_int):
        k, _, ic, oc = w.shape
        split = kc.pe_split[i]
        assert split == (exact and i == L - 1)          # sr_x2: the last conv only
        n_pass, chunks, tap_major = convert.layer_geometry(k, ic, split, qp.hw.pe)
        assert n_pass == ((ic if ic <= 4 else 4) if split else 1)
        assert tap_major == (split or ic <= 4)
        nt = -(-oc // 8)
        assert offsets[i] % 4 == 0
        chunk = kc.weights[offsets[i]: offsets[i + 1]]
        b = _unpack(chunk.reshape(n_pass, chunks, 32, nt, 2))   # (..., 4 bytes)
        taps = w.reshape(k * k, ic, oc)
        rebuilt = np.zeros_like(taps)
        seen = np.zeros(taps.shape, int)
        for p, c, lane, n, reg in np.ndindex(b.shape[:-1]):
            g, t = divmod(lane, 4)
            slot = t + 4 * reg
            tap, word = ((8 * c + slot, p if ic > 4 else 0) if tap_major
                         else (2 * c + slot // 4, slot % 4))
            o = 8 * n + g if i == L - 1 else (g >> 1) + 4 * (g & 1) + 8 * n
            for j, v in enumerate(b[p, c, lane, n, reg]):
                ch = j if ic <= 4 else word + 4 * j
                owned = not split or ch % 4 == p
                if tap >= k * k or o >= oc or ch >= ic or not owned:
                    assert v == 0, (i, p, c, lane, n, reg, j)
                    continue
                rebuilt[tap, ch, o] += v
                seen[tap, ch, o] += 1
        np.testing.assert_array_equal(rebuilt, taps, err_msg=f"layer {i}")
        assert (seen == 1).all()
        bias = kc.param("bias", i)[:oc]
        zc = kc.param("zc", i)[:oc]
        if exact:
            np.testing.assert_array_equal(bias, qp.fused_bias(i))
            assert not zc.any()
        else:
            np.testing.assert_array_equal(bias, np.clip(qp.bias_int[i], -32768, 32767))
            np.testing.assert_array_equal(zc, qp.effective_zero(i) * w.sum(axis=(0, 1, 2)))
        assert kc.param("z_eff", i) == qp.effective_zero(i)
        assert kc.param("z_in", i).view(np.float32) == qp.a_zero[i]
        m_f, p_f = np.array([kc.param("rq_m", i), kc.param("rq_p", i)]).view(np.float32)
        assert (m_f, p_f) == (np.float32(qp.requant_m[i]),
                              np.float32(2.0 ** -qp.requant_n[i]))
    assert kc.param("acc_hi") == 2 ** 17 - 1
    assert kc.param("add_hi") == 2 ** 19 - 1


def test_kernel_constants_refuse_what_the_kernels_cannot_run():
    spec, (qp, _) = spec_for_task("sr_x2"), _artifact("sr_x2")
    az = list(qp.a_zero)
    az[2] = 200                                  # z_eff does not fit the int8 pads
    with pytest.raises(NotImplementedError, match="does not fit int8"):
        convert.kernel_constants(spec, dataclasses.replace(qp, a_zero=az), "exact")
    # any PE count from 1 to 16 runs (the general instantiation off 4 PEs);
    # 2- to 8-bit activations and widths up to 64 are what the kernels
    # hold; past 16 convs a network runs in layer groups
    assert convert.kernel_constants(spec, dataclasses.replace(
        qp, hw=dataclasses.replace(qp.hw, pe=2)), "exact").general
    for hw in (dataclasses.replace(qp.hw, pe=17), dataclasses.replace(qp.hw, quan_bits=16)):
        with pytest.raises(NotImplementedError, match="PEs|quan_bits"):
            convert.kernel_constants(spec, dataclasses.replace(qp, hw=hw), "exact")
    with pytest.raises(NotImplementedError, match="widths of at most 64"):
        convert.kernel_constants(dataclasses.replace(spec, num_channels=80), qp, "fast")
    deep = dataclasses.replace(spec, num_lblocks=15)
    kc = convert.kernel_constants(deep, deepened(qp, 17), "fast")
    assert [(g.first, g.last) for g in kc.groups] == [(0, 8), (9, 16)] and kc.general
    # any odd conv size from 1 to 9 runs (tests/test_torch_ksizes.py); an
    # even one is refused, and weights of another size than the spec's
    with pytest.raises(NotImplementedError, match=r"is 4x4 \(an even size"):
        convert.kernel_constants(dataclasses.replace(spec, k_block=4), qp, "fast")
    with pytest.raises(ValueError, match="is 5x5, its weights"):
        convert.kernel_constants(dataclasses.replace(spec, k_block=5), qp, "fast")
    with pytest.raises(ValueError, match="datapath"):
        convert.kernel_constants(spec, qp, True)
    with pytest.raises(ValueError, match="split flag"):
        convert.kernel_constants(spec, qp, "corrected")
    for task in ("nr", "dm", "nrdm_3", "nrdm_6", "sr_x4"):
        tspec, (tqp, _) = spec_for_task(task), _artifact(task)
        for datapath in ("exact", "fast"):
            convert.kernel_constants(tspec, tqp, datapath)
        for split in (convert.corrected_split_layers(tqp), (True,) * tspec.num_convs):
            convert.kernel_constants(tspec, tqp, "corrected", split)


KMAGIC = np.float32(12582912.0)             # csrc/sesr_net.cu kMagic = 1.5 * 2^23
TOP_M = (1 << 22) - 1


def _requant_pairs(source):
    """(m, n) of every requantization of the shipped artifacts, of the
    goldens, or the edges kernel_constants still admits."""
    pairs = set()
    if source == "artifacts":
        for path in ARTIFACTS:
            qp = QuantParams.load(path)
            pairs.update(zip(qp.requant_m, qp.requant_n))
            pairs.add((qp.res_requant_m, qp.res_requant_n))
    elif source == "goldens":
        for task in SIM_GOLDENS:
            g = _load_golden(task)
            pairs.update((int(g[f"requan_m_{i}"]), int(g[f"requan_n_{i}"]))
                         for i in range(int(g["num_convs"])))
            pairs.add((int(g["res_requant_m"]), int(g["res_requant_n"])))
    else:
        pairs.update((m, n) for m in (1, 3, 40961, TOP_M - 1, TOP_M)
                     for n in (-64, -63, -1, 0, 1, 16, 31, 63, 64))
    return sorted(pairs)


@pytest.mark.parametrize("source", ["artifacts", "goldens", "edges"])
def test_single_rounding_requant_matches_plain(source):
    """The kernels requantize with one rounding of y * (m * 2^-n): the FFMA
    fl(a * s - kMagic * s) on the accumulator's bits a = kMagic + y, and the
    residual rescale fl(t * s). The plain version rounds twice, (y * m) *
    2^-n. For every (m, n) and y over +-2^20 they must give the same float32.
    The model of the FFMA is exact: a * s fits 46 bits and y * s 43 bits of
    a float64, so its one rounding is the cast to float32."""
    pairs = _requant_pairs(source)
    assert pairs
    rng = np.random.default_rng(17)
    y = np.concatenate([np.arange(-2 ** 20, 2 ** 20 + 1, 4097),
                        rng.integers(-2 ** 20, 2 ** 20 + 1, 8192),
                        [0, 1, -1, 2 ** 20, -2 ** 20, 2 ** 20 - 1, 1 - 2 ** 20]])
    y32 = y.astype(np.float32)
    assert (y32.astype(np.int64) == y).all()
    a = KMAGIC + y32                                        # bits kMagicBits + y
    assert (a.astype(np.float64) - np.float64(KMAGIC) == y).all()
    for m, n in pairs:
        assert 0 <= m <= TOP_M and -64 <= n <= 64, (m, n)
        m_f, p_f = (np.float32(v) for v in fixedpoint.requant_factors(m, n))
        s = m_f * p_f                                       # rq_s: __fmul_rn, exact
        c = -KMAGIC * s                                     # rq_c, exact
        assert float(s) == m * 2.0 ** -n and float(c) == -1.5 * 2.0 ** 23 * m * 2.0 ** -n
        want = fixedpoint.apply_requant_f32(torch.from_numpy(y32), m, n).numpy()
        ffma = (a.astype(np.float64) * np.float64(s) + np.float64(c)).astype(np.float32)
        np.testing.assert_array_equal(ffma, want, err_msg=f"FFMA m={m} n={n}")
        fmul = (y32.astype(np.float64) * np.float64(s)).astype(np.float32)
        np.testing.assert_array_equal(fmul, want, err_msg=f"residual m={m} n={n}")


@pytest.mark.parametrize("field,index,value", [
    ("requant_m", 2, 1 << 22), ("requant_n", 3, 65), ("requant_n", 1, -65),
    ("res_requant_m", None, 1 << 22), ("res_requant_n", None, -65)])
def test_kernel_constants_refuse_requant_beyond_one_rounding(field, index, value):
    """An (m, n) outside m < 2^22, |n| <= 64 is refused by both kernels; the
    edges inside are taken."""
    spec, (qp, _) = spec_for_task("sr_x2"), _artifact("sr_x2")

    def with_value(v):
        if index is None:
            return dataclasses.replace(qp, **{field: v})
        vals = list(getattr(qp, field))
        vals[index] = v
        return dataclasses.replace(qp, **{field: vals})

    for datapath in ("exact", "fast"):
        with pytest.raises(NotImplementedError, match="requantization"):
            convert.kernel_constants(spec, with_value(value), datapath)
    edge = TOP_M if field.endswith("_m") else (64 if value > 0 else -64)
    convert.kernel_constants(spec, with_value(edge), "exact")


def test_fast_shortcut_int16_bound():
    """The fast kernel keeps conv 0's rounded ReLU output as int16: the
    static bound holds on data and an artifact beyond int16 is refused (the
    PE-exact kernel stores clip(round(s - 128)) as int8 and needs no bound)."""
    spec, (qp, _) = spec_for_task("sr_x2"), _artifact("sr_x2")
    bound = convert.shortcut_bound(qp)
    assert 0 < bound <= 32767
    x = np.random.default_rng(3).random((1, 24, 40, 3), dtype=np.float32)
    _, dumps = integer_forward(spec, qp, x, collect_dumps=True, corrected=True,
                               compute="fast", device="cpu")
    assert float(torch.round(dumps["shortcut"]).max()) <= bound
    big = dataclasses.replace(qp, requant_m=[qp.requant_m[0] * 8] + list(qp.requant_m[1:]))
    assert convert.shortcut_bound(big) > 32767
    with pytest.raises(NotImplementedError, match="int16"):
        convert.kernel_constants(spec, big, "fast")
    with pytest.raises(NotImplementedError, match="int16"):
        convert.kernel_constants(spec, big, "corrected", (True,) * spec.num_convs)
    convert.kernel_constants(spec, big, "exact")


def test_device_constants_cached_per_instance():
    spec, (qp, _) = spec_for_task("sr_x2"), _artifact("sr_x2")
    cpu = torch.device("cpu")
    a = convert.device_constants(spec, qp, "exact", cpu)
    assert convert.device_constants(spec, qp, "exact", cpu) is a
    copy = dataclasses.replace(qp)
    assert convert.device_constants(spec, copy, "exact", cpu) is not a
    assert a[1].dtype == a[2].dtype == torch.int32
    # the corrected kernel's constants are kept per split mask
    one, every = (False,) * 4 + (True,), (True,) * 5
    b = convert.device_constants(spec, qp, "corrected", cpu, one)
    assert convert.device_constants(spec, qp, "corrected", cpu, list(one)) is b
    c = convert.device_constants(spec, qp, "corrected", cpu, every)
    assert c is not b and b[0].pe_split == one and c[0].pe_split == every


@pytest.mark.parametrize("kern", kernels.NET_KERNELS, ids=lambda k: k.symbol)
def test_launch_plan_kept_per_key(kern, monkeypatch):
    """A wrapper reckons its tile and shared memory once per (spec, split,
    PE count, instantiation, tile): a second call costs no reckoning, and
    a tile that does not fit is refused each time."""
    spec = spec_for_task("sr_x2")
    split = (True,) * spec.num_convs
    kern._plans.clear()
    tile, need = kern.plan(spec, split, 4)
    assert tile == kern.tile(spec, split, 4) and need == kern.smem_bytes(spec, tile, split, 4)
    assert kern.plan(spec, split, 4, False, tile) == (tile, need)
    monkeypatch.setattr(kern, "smem_bytes", lambda *a, **k: 1 / 0)
    assert kern.plan(spec, split, 4) == (tile, need)
    assert kern.plan(spec, list(split), 4, False, list(tile)) == (tile, need)
    monkeypatch.undo()
    for _ in range(2):
        with pytest.raises(ValueError, match="more than a block's"):
            kern.plan(spec, split, 4, False, (256, 256))


def test_cpu_tensors_take_the_plain_path_without_building(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a CPU call reached the kernel build")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "find_nvcc", refuse)
    kernels.reset_launch_counts()
    spec, (qp, _) = spec_for_task("sr_x2"), _artifact("sr_x2")
    x = torch.from_numpy(np.random.default_rng(0).random((1, 12, 20, 3),
                                                         dtype=np.float32))
    assert pe_exact_forward(spec, qp, x).shape == (1, 24, 40, 3)
    assert fast_forward(spec, qp, x, out_dtype="int8").dtype == torch.int8
    for task in ("sr_x2", "nr"):                 # fast, hybrid
        tqp, _ = _artifact(task)
        _, fn = deploy.select_forward(tqp)
        fn(spec_for_task(task), tqp, torch.zeros((1, 12, 20, 3)))
    assert [k.launches for k in kernels.NET_KERNELS] == [0, 0, 0]
    assert "triton" not in sys.modules
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.fast_net(spec, qp, torch.zeros((1, 8, 8, 3), dtype=torch.int8))


def test_other_devices_never_fall_back():
    spec, (qp, _) = spec_for_task("sr_x2"), _artifact("sr_x2")
    nr_qp, _ = _artifact("nr")
    x = torch.zeros((1, 8, 8, 3), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        pe_exact_forward(spec, qp, x)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fast_forward(spec, qp, x)
    mode, fn = deploy.select_forward(nr_qp)
    assert mode == "hybrid"
    with pytest.raises(ValueError, match="cuda or cpu"):
        fn(spec_for_task("nr"), nr_qp, x)
    mode, fn = deploy.select_forward(dataclasses.replace(nr_qp, fast_cert_layers=None))
    assert mode == "pe-exact"
    with pytest.raises(ValueError, match="cuda or cpu"):
        fn(spec_for_task("nr"), nr_qp, x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.corrected_net(spec, qp, torch.zeros((1, 8, 8, 3), dtype=torch.int8),
                              split=(False,) * 5)


@pytest.mark.parametrize("path", ARTIFACTS, ids=os.path.basename)
def test_select_forward_matches_jax(path):
    mode, _ = deploy.select_forward(QuantParams.load(path))
    assert mode == select_packed_forward(JQuantParams.load(path))[0]


@pytest.mark.parametrize("stamped", [True, False], ids=["stamped", "unstamped"])
@pytest.mark.parametrize("task", ["nr", "dm", "nrdm_3", "nrdm_6", "sr_x4", "sr_x2"])
def test_hybrid_plain_matches_jax_hybrid(task, stamped):
    """The plain hybrid forward (the artifact's stamps) and the corrected
    PE-exact one (its stamps removed) are array-equal to the JAX package's
    packed_hybrid_forward and packed_exact_forward(corrected=True), in both
    output contracts; select_forward picks them as JAX does."""
    qp, jqp = _artifact(task)
    spec, jspec = spec_for_task(task), jspec_for_task(task)
    x = np.random.default_rng(5).random((1, 24, 40, spec.in_channels), dtype=np.float32)
    if not stamped:
        qp = dataclasses.replace(qp, fast_cert_layers=None, fast_cert_ok=False)
        jqp = dataclasses.replace(jqp, fast_cert_layers=None, fast_cert_ok=False)
    mode, fn = deploy.select_forward(qp)
    assert mode == select_packed_forward(jqp)[0]
    if stamped:
        assert mode in ("fast", "hybrid")
        fn = corrected.hybrid_forward
    else:
        assert mode == "pe-exact"
    for out_dtype in OUT_DTYPES:
        if stamped:
            want = packed_hybrid_forward(jspec, jqp, jnp.asarray(x), out_dtype=out_dtype)
        else:
            want = packed_exact_forward(jspec, jqp, jnp.asarray(x), corrected=True,
                                        out_dtype=out_dtype)
        got = fn(spec, qp, x, out_dtype=out_dtype, device="cpu")
        assert got.dtype == (torch.int8 if out_dtype == "int8" else torch.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
