"""Networks of more than 16 convs: the layer-group form of the fused kernels
(csrc/sesr_net_group.cu, csrc/sesr_corrected_group.cu) on the CPU.

One artifact, calibrated by the JAX package: a 34-conv network at width 8
(x2 RGB), and an 18-conv one cut from it (its first 17 convs and its last:
every number of the cut artifact is one of the calibrated ones, the
network it describes is a new one). On them: the port's plain
interpreter against the JAX package's, every dump; the plain version of a
group (``group_forward``) from each group's input against the whole
interpreter, for every group of 3 or more convs of the 18-conv network
(so every partition into such groups); the chain (``group_chain``) in
every residual mode; each group's parameter block against the network's
records, for the rule's partition and a forced one; the partition rule
(``convert.layer_groups``), which keeps every network that runs in one
launch today in that launch at its tile and puts chip_smoke.py's sweep
networks (33 convs) in three groups or more; and K1's split last conv
staged one PE pass at a time (SESR-XL x4 RGB at 5-16 PEs). The kernels themselves run on the card only (chip_smoke.py phase
16)."""

import dataclasses
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesr_tpu.config import SESRSpec as JSESRSpec
from sesr_tpu.models.sesr import init_params as jinit_params
from sesr_tpu.quant.calibrate import calibrate as jcalibrate
from sesr_tpu.quant.integer import integer_forward as jinteger_forward
from sesr_tpu_torch import convert
from sesr_tpu_torch.config import HardwareConfig, SESRSpec, spec_for_task
from sesr_tpu_torch.ops.corrected import split_layers
from sesr_tpu_torch.ops.kernels import (NET_KERNELS, SMEM_LIMIT, corrected_group_plan,
                                        corrected_net, net_group_smem_bytes, pe_exact_net)
from sesr_tpu_torch.quant.integer import (group_chain, group_forward, integer_forward,
                                          shortcut_term)
from sesr_tpu_torch.quant.params import QuantParams
from tests.test_torch_params import one_torch_thread  # noqa: F401 (fixture)

H, W = 24, 32
DEEP = dict(name="deep34", in_channels=3, out_channels=3, num_channels=8, num_lblocks=32,
            scaling_factor=2)
ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "artifacts")
MODES = {"reference": dict(corrected=False), "corrected": dict(corrected=True),
         "fast": dict(corrected=True, compute="fast")}


@functools.lru_cache(maxsize=None)
def _deep34():
    """(JAX spec, JAX QuantParams) of the 34-conv network."""
    jspec = JSESRSpec(**DEEP)
    rng = np.random.default_rng(34)
    images = [rng.random((1, H, W, 3), dtype=np.float32)]
    return jspec, jcalibrate(jspec, jinit_params(jspec, jax.random.PRNGKey(34)), images,
                             safe_zero_floor=True)


def _cut(jqp, keep):
    """The artifact of convs ``keep`` (domains: each kept conv's input, then
    the output)."""
    L = len(jqp.w_int)
    dom = [*keep, L]
    per_conv = {f: [getattr(jqp, f)[i] for i in keep]
                for f in ("w_int", "bias_f", "bias_int", "w_scale", "requant_m", "requant_n")}
    return dataclasses.replace(jqp, **per_conv, a_scale=[jqp.a_scale[d] for d in dom],
                               a_zero=[jqp.a_zero[d] for d in dom])


@functools.lru_cache(maxsize=None)
def _network(convs):
    """(port spec, JAX spec, port QuantParams, JAX QuantParams) of the 34- or
    18-conv network."""
    jspec, jqp = _deep34()
    if convs != 34:
        jqp = _cut(jqp, [*range(convs - 1), 33])
        jspec = dataclasses.replace(jspec, name=f"deep{convs}", num_lblocks=convs - 2)
    spec = SESRSpec(**{**DEEP, "name": jspec.name, "num_lblocks": convs - 2})
    qp = convert.quantparams_from_fields({f.name: getattr(jqp, f.name)
                                          for f in dataclasses.fields(jqp)})
    return spec, jspec, qp, jqp


def deepened(qp, convs):
    """An artifact of ``convs`` convs from ``qp``'s: its first conv, its
    middle convs over and over, its last conv (each conv's numbers with
    the domain it reads; for the plans and constants of a deeper network,
    not a calibrated one)."""
    L0 = qp.num_convs
    src = [0, *(1 + i % (L0 - 2) for i in range(convs - 2)), L0 - 1]
    per_conv = {f: [getattr(qp, f)[i] for i in src]
                for f in ("w_int", "bias_f", "bias_int", "w_scale", "requant_m", "requant_n")}
    return dataclasses.replace(qp, **per_conv, a_scale=[qp.a_scale[d] for d in (*src, L0)],
                               a_zero=[qp.a_zero[d] for d in (*src, L0)])


def _x(seed=0, n=1):
    return np.random.default_rng(seed).random((n, H, W, 3), dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _dumps(convs, mode):
    spec, _, qp, _ = _network(convs)
    if mode == "fast":
        qp = dataclasses.replace(qp, fast_cert_ok=True)
    return integer_forward(spec, qp, _x(), collect_dumps=True, device="cpu", **MODES[mode])


@pytest.mark.parametrize("convs", [18, 34])
@pytest.mark.parametrize("corrected", [False, True])
def test_the_plain_interpreter_matches_jax_on_deep_networks(convs, corrected, one_torch_thread):
    """The port's integer_forward against the JAX package's at 18 and 34
    convs: the output and every dump array_equal."""
    spec, jspec, qp, jqp = _network(convs)
    y_j, d_j = jinteger_forward(jspec, jqp, jnp.asarray(_x()), collect_dumps=True,
                                corrected=corrected)
    y_t, d_t = _dumps(convs, "corrected" if corrected else "reference")
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    assert sorted(d_t) == sorted(d_j)
    for k in d_j:
        np.testing.assert_array_equal(d_t[k].numpy(), np.asarray(d_j[k]), err_msg=k)
    assert d_t["input.0"].shape == (1, H, W, 3) and len(d_t["overflow_18"]) == convs


@pytest.mark.parametrize("mode", ["reference", "corrected", "hybrid", "fast"])
def test_every_group_of_three_or_more_convs_equals_the_whole(mode, one_torch_thread):
    """group_forward from input.{first} and the shortcut gives the whole
    interpreter's input.{last + 1} (the output at the last conv) and its
    overflow_18 on the group's convs, for every group of 3 or more
    consecutive convs of the 18-conv network: so every partition into such
    groups chains to the whole forward."""
    spec, _, qp, _ = _network(18)
    L = spec.num_convs
    dense = None
    if mode == "fast":
        qp = dataclasses.replace(qp, fast_cert_ok=True)
        dense = (True,) * L
    kw = dict(MODES.get(mode, MODES["corrected"]))
    if mode == "hybrid":
        dense = tuple(bool(b) for b in np.random.default_rng(5).random(L) < 0.5)
        kw["fast_layers"] = dense
    _, d = integer_forward(spec, qp, _x(), collect_dumps=True, device="cpu", **kw)
    for first in range(L - 2):
        for last in range(first + 2, L):
            shortcut = None if first == 0 else d["shortcut"]
            got, sc, counts = group_forward(spec, qp, d[f"input.{first}"], shortcut, first, last,
                                            kw["corrected"], dense)
            assert torch.equal(got, d[f"input.{last + 1}"]), (mode, first, last)
            assert torch.equal(counts, d["overflow_18"][first:last + 1]), (mode, first, last)
            assert torch.equal(sc, d["shortcut"])


@pytest.mark.parametrize("residual_mode", ["sim", "graph_add", "graph_add_qat"])
def test_the_chain_equals_the_whole_in_every_residual_mode(residual_mode, one_torch_thread):
    """group_chain over the partition rule's groups, an uneven partition and
    groups of three equals integer_forward on the 34-conv network, the
    crossing values equal its dumps, in each residual wiring (the kernels
    serve "sim"; the graph modes add the shortcut ahead of the last conv
    too, and the chain carries it to that group)."""
    spec, _, qp, _ = _network(34)
    L = spec.num_convs
    bounds = (0.0, 4.0) if residual_mode == "graph_add_qat" else None
    for corrected in (False, True):
        y, d = integer_forward(spec, qp, _x(1), collect_dumps=True, corrected=corrected,
                               device="cpu", residual_mode=residual_mode, qat_add_bounds=bounds)
        for groups in (convert.balanced_groups(L, 3), ((0, 15), (16, 19), (20, 33)),
                       convert.balanced_groups(L, L // 3)):
            got, seen = group_chain(spec, qp, _x(1), groups, corrected=corrected,
                                    device="cpu", residual_mode=residual_mode,
                                    qat_add_bounds=bounds)
            assert torch.equal(got, y), (corrected, groups)
            for first, _ in groups:
                assert torch.equal(seen[f"input.{first}"], d[f"input.{first}"])
            assert torch.equal(seen["overflow_18"], d["overflow_18"])


def test_the_shortcut_term_is_what_the_last_conv_consumes():
    """shortcut_term (what the first group hands the last one) read back as
    the last conv's domain-in reads the shortcut: K1's clip(round(s - 128))
    as int8 plus 128, the corrected datapath's round(s) as int16."""
    spec, _, qp, _ = _network(18)
    for mode, datapath in (("reference", "exact"), ("corrected", "corrected")):
        _, d = _dumps(18, mode)
        s = d["shortcut"]
        term = shortcut_term(s, qp, datapath)
        if datapath == "exact":
            assert term.dtype == torch.int8
            assert torch.equal(torch.clamp(torch.round(s - 128), -128, 127), term.float())
        else:
            assert term.dtype == torch.int16 and torch.equal(torch.round(s), term.float())


@pytest.mark.parametrize("datapath", convert.DATAPATHS)
def test_each_group_block_holds_the_network_records(datapath, one_torch_thread):
    """The 34-conv network runs in groups in every kernel; each group's
    block is the network's head with the group's own split and clamp bits,
    the network's records of its convs (and of the next conv before the
    last group), and their per-PE rows."""
    spec, _, qp, _ = _network(34)
    L = spec.num_convs
    split = split_layers(qp, "pe-exact") if datapath == "corrected" else None
    kc = convert.kernel_constants(spec, qp, datapath, split)
    assert len(kc.groups) >= 3 and kc.general
    assert [g.first for g in kc.groups] == [0] + [g.last + 1 for g in kc.groups[:-1]]
    assert kc.groups[-1].last == L - 1
    rw, width = convert.record_words(kc.width), kc.width
    for g in kc.groups:
        R = convert.group_records(g.convs, g.flags)
        assert g.flags == ((g.first == 0) | 2 * (g.last == L - 1))
        assert R == g.convs + (g.last < L - 1)
        mine = g.params
        np.testing.assert_array_equal(mine[:5], kc.params[:5])
        np.testing.assert_array_equal(mine[7:8], kc.params[7:8])
        assert mine[convert.HEAD["pe_split"]] == g.split == sum(
            1 << j for j in range(g.convs) if kc.pe_split[g.first + j])
        assert mine[convert.HEAD["clamp20"]] == (1 << g.convs) - 1
        at = convert.param_at("w_off", g.first, width)
        np.testing.assert_array_equal(mine[8:8 + R * rw], kc.params[at:at + R * rw])
        for j in range(R):
            for p in range(kc.pe):
                src = convert.zc_pe_at(L, width, kc.pe, g.first + j, p)
                dst = convert.zc_pe_at(R, width, kc.pe, j, p)
                np.testing.assert_array_equal(mine[dst:dst + width], kc.params[src:src + width])
        assert mine.size == convert.block_words(kc.pe, R, width, 0)


def test_forced_partitions_are_checked(one_torch_thread):
    """Any partition, not only the rule's, built by ``group_constants`` from
    the network's block: the rule's groups of the 18-conv network rebuilt
    equal kernel_constants' own, and three groups of six convs (a first, a
    middle and a last group) carry their flags, split and clamp bits and
    the network's records of their convs (and of the next conv before the
    last group), in every datapath."""
    spec, _, qp, _ = _network(18)
    L = spec.num_convs
    for datapath in convert.DATAPATHS:
        split = split_layers(qp, "pe-exact") if datapath == "corrected" else None
        kc = convert.kernel_constants(spec, qp, datapath, split)
        args = (kc.params, L, kc.width, kc.pe, kc.out_channels, kc.pe_split, kc.clamp20)
        assert [(g.first, g.last) for g in kc.groups] == [(0, 8), (9, 17)]
        for g in kc.groups:
            again = convert.group_constants(*args, g.first, g.last)
            assert (again.first, again.convs, again.flags, again.split) == \
                (g.first, g.convs, g.flags, g.split)
            np.testing.assert_array_equal(again.params, g.params)
        forced = [convert.group_constants(*args, a, b) for a, b in ((0, 5), (6, 11), (12, 17))]
        assert [(g.first, g.last, g.flags) for g in forced] == [(0, 5, 1), (6, 11, 0),
                                                                (12, 17, 2)]
        rw = convert.record_words(kc.width)
        for g in forced:
            R = convert.group_records(g.convs, g.flags)
            assert g.params[convert.HEAD["pe_split"]] == g.split == sum(
                1 << j for j in range(g.convs) if kc.pe_split[g.first + j])
            assert g.params[convert.HEAD["clamp20"]] == (1 << g.convs) - 1
            at = convert.param_at("w_off", g.first, kc.width)
            np.testing.assert_array_equal(g.params[8:8 + R * rw], kc.params[at:at + R * rw])


def test_the_partition_rule():
    """The fewest groups of at most 16 convs that fit, as equal as possible,
    the longer first; none where not even groups of two fit."""
    assert convert.layer_groups(18, lambda a, b: True) == ((0, 8), (9, 17))
    assert convert.layer_groups(33, lambda a, b: True) == ((0, 10), (11, 21), (22, 32))
    assert convert.layer_groups(24, lambda a, b: b - a < 8) == ((0, 7), (8, 15), (16, 23))
    assert convert.layer_groups(17, lambda a, b: b - a < 5) == (
        (0, 4), (5, 8), (9, 12), (13, 16))
    assert convert.layer_groups(20, lambda a, b: False) is None
    assert convert.balanced_groups(7, 3) == ((0, 2), (3, 4), (5, 6))


def _chip_smoke():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    module_spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=None)
def _calibrated(kw):
    """A seeded network calibrated by the port on the CPU (the plans depend
    on the shapes, the PE count and the split masks)."""
    from sesr_tpu_torch.models.sesr import init_params
    from sesr_tpu_torch.quant.calibrate import calibrate
    spec = SESRSpec(**dict(kw))
    params = init_params(spec, torch.Generator().manual_seed(0))
    images = [np.random.default_rng(0).random((1, 16, 16, spec.in_channels), dtype=np.float32)]
    return spec, calibrate(spec, params, images, safe_zero_floor=True, device="cpu")


def _modes(kern, qp):
    if kern is corrected_net:
        return [split_layers(qp, "pe-exact"), tuple(not s for s in qp.fast_cert_layers)
                if qp.fast_cert_layers is not None else (True,) * qp.num_convs]
    return [None]


def _one_launch_cases():
    cs = _chip_smoke()
    cases = []
    for task in ("nr", "dm", "nrdm_3", "nrdm_6", "sr_x4", "sr_x2"):
        qp = QuantParams.load(os.path.join(ARTIFACT_DIR, f"qparams_{task}.npz"))
        cases.append((f"{task}", spec_for_task(task), qp))
    nets = {**cs.FAMILY_NETS, **cs.OUT_NETS, **cs.SWEEP_NETS}
    for name, kw in nets.items():
        spec, qp = _calibrated(tuple(sorted(kw.items())))
        configs = {**cs.HW_CONFIGS, **cs.SWEEP_HW}
        for cname, hw in configs.items():
            cqp = dataclasses.replace(qp, hw=HardwareConfig(**hw))
            cases.append((f"{name} {cname}", spec, cqp))
            if name in ("xl", "m11"):          # phase 14's saturated copies
                sat = dataclasses.replace(cqp, w_int=[
                    np.full_like(np.asarray(w), 127) if i in cs.SATURATED else np.asarray(w)
                    for i, w in enumerate(cqp.w_int)])
                cases.append((f"{name} {cname} saturated", spec, sat))
    return cases


def test_every_network_that_runs_today_keeps_one_launch_at_its_tile(monkeypatch,
                                                                    one_torch_thread):
    """The shipped tasks, SESR-M11, SESR-XL (and their saturated copies),
    phase 15's networks and its sweep's, at phase 12's and the sweep's
    configs, in each kernel (the corrected kernel in the PE-exact mode and
    with every conv split): every (network, kernel) whose plan fits a block
    at the kernel's smallest tile runs in one launch (no groups) at the tile
    ``tile`` picks, as before; one whose plan fits no tile, which the
    kernel refused before, runs in groups that fit (K1 on SESR-XL x4 RGB
    with a split last conv past four PEs: one group, the last conv staged
    a pass at a time; the corrected kernel with every conv split at 8 PE
    groups). (The B words are not packed here: the plans depend on the
    shapes, PEs and split masks alone.)"""
    monkeypatch.setattr(convert, "_fragment_words", lambda *a, **k: np.zeros(8, np.int32))
    monkeypatch.setattr(convert, "_wgmma_b_words", lambda *a, **k: np.zeros(8, np.int32))
    grouped = set()
    for label, spec, qp in _one_launch_cases():
        for kern in NET_KERNELS:
            for split in _modes(kern, qp):
                try:
                    kc = convert.kernel_constants(spec, qp, kern.datapath, split)
                except NotImplementedError as e:
                    assert "shortcut" in str(e), (label, kern.symbol, e)
                    continue
                old = kern.smem_bytes(spec, kern.tiles[-1], kc.pe_split, kc.pe, kc.general)
                plans = kern.launch_plans(spec, kc)
                assert all(need <= SMEM_LIMIT for _, _, need in plans)
                if kc.groups:
                    assert old > SMEM_LIMIT, (label, kern.symbol)
                    grouped.add((kern.symbol, len(kc.groups)))
                    continue
                (group, tile, _), = plans
                assert group is None and tile == kern.tile(spec, kc.pe_split, kc.pe, kc.general)
    assert ("sesr_pe_exact_net", 1) in grouped


PHASE16 = {"m16": dict(name="sesr_m16_x2", in_channels=3, out_channels=3, num_channels=16,
                       num_lblocks=16, scaling_factor=2),
           "xl22": dict(name="sesr_xl22_x2", in_channels=3, out_channels=3, num_channels=32,
                        num_lblocks=22, scaling_factor=2)}


@pytest.mark.parametrize("net", sorted(PHASE16))
def test_deep_networks_run_in_groups_that_fit(net, one_torch_thread):
    """chip_smoke.py phase 16's networks (18 and 24 convs) at 4 and 16 PEs,
    wide sums or not, in every kernel: two or more groups, each fitting a
    block at its tile, the group plans as the kernels' own rule takes
    them."""
    cs = _chip_smoke()
    assert cs.DEEP_NETS[net] == PHASE16[net]
    spec, qp = _calibrated(tuple(sorted(PHASE16[net].items())))
    for cname in ("pe4", "pe16", "pe16_wide"):
        cqp = dataclasses.replace(qp, hw=HardwareConfig(**cs.HW_CONFIGS.get(cname, {})))
        for kern in NET_KERNELS:
            for split in _modes(kern, cqp):
                kc = convert.kernel_constants(spec, cqp, kern.datapath, split)
                assert len(kc.groups) >= 2 and kc.general, (net, cname, kern.symbol)
                for g, tile, need in kern.launch_plans(spec, kc):
                    assert need <= SMEM_LIMIT
                    flags, n = g.flags, g.convs
                    sp = kc.pe_split[g.first:g.last + 1]
                    if kern is corrected_net:
                        want = corrected_group_plan(n, flags, 3, 12, tile, sp, kc.pe, kc.width)
                        assert need == want.bytes
                    else:
                        assert need == net_group_smem_bytes(kern.datapath, n, flags, 3, 12, tile,
                                                            sp, kc.pe, kc.width)


@pytest.mark.parametrize("net", [f"g{c}_{oc}" for c in (16, 32) for oc in (3, 12, 27, 48)])
def test_the_group_sweep_runs_a_middle_group(net, monkeypatch, one_torch_thread):
    """chip_smoke.py phase 16's sweep networks (33 convs) at each sweep
    config, in each kernel and mode the sweep runs (the corrected kernel's
    at every output count: past 16 outputs its last group runs in the tail
    instantiations): three groups or more (a first, a middle and a last
    group, the partition rule's own), each fitting a block at its tile."""
    monkeypatch.setattr(convert, "_fragment_words", lambda *a, **k: np.zeros(8, np.int32))
    monkeypatch.setattr(convert, "_wgmma_b_words", lambda *a, **k: np.zeros(8, np.int32))
    cs = _chip_smoke()
    spec, qp = _calibrated(tuple(sorted(cs.GROUP_NETS[net].items())))
    assert spec.num_convs == 33
    for cname, hw in cs.SWEEP_HW.items():
        cqp = dataclasses.replace(qp, hw=HardwareConfig(**hw), fast_cert_layers=None,
                                  fast_cert_ok=False)
        modes = ["sim", "k2"] if cqp.hw.pe == 4 else ["sim"]
        modes += ["pe-exact", "audit"]
        for mode in modes:
            kern, _, kc = cs.mode_constants(mode, spec, cqp)
            plans = kern.launch_plans(spec, kc)
            assert len(plans) >= 3 and plans[1][0].flags == 0, (net, cname, mode)
            assert [(g.first, g.last) for g, _, _ in plans] == list(
                convert.balanced_groups(33, len(plans)))
            assert all(need <= SMEM_LIMIT for _, _, need in plans)


@pytest.mark.parametrize("pe", range(5, 17))
def test_k1_stages_the_split_last_conv_of_xl_x4_rgb(pe, one_torch_thread):
    """SESR-XL x4 RGB (48 outputs) with its last conv at +127 past four PEs
    (the network K1 refused at 16 PEs): K1 takes it at every PE count; where
    its split last conv's B fits no tile beside K1's buffers (at 16 PEs) it
    runs in one group of the layer-group form, that conv's B staged one PE
    pass at a time, and that staged plan fits a block at every PE count."""
    cs = _chip_smoke()
    spec, qp = _calibrated(tuple(sorted(cs.OUT_NETS["sesr_xl_x4_rgb"].items())))
    L = spec.num_convs
    qp = dataclasses.replace(qp, hw=HardwareConfig(pe=pe), w_int=[
        np.full_like(np.asarray(w), 127) if i == L - 1 else np.asarray(w)
        for i, w in enumerate(qp.w_int)])
    kc = convert.kernel_constants(spec, qp, "exact")
    assert kc.pe_split[L - 1] and kc.general
    staged = min(net_group_smem_bytes("exact", L, 3, 3, 48, t, kc.pe_split, pe, 32)
                 for t in pe_exact_net.tiles)
    assert staged <= SMEM_LIMIT
    old = pe_exact_net.smem_bytes(spec, (8, 8), kc.pe_split, pe, True)
    assert bool(kc.groups) == (old > SMEM_LIMIT) and (pe < 16 or kc.groups)
    if kc.groups:
        (g, tile, need), = pe_exact_net.launch_plans(spec, kc)
        assert (g.first, g.last, g.flags) == (0, L - 1, 3) and need <= SMEM_LIMIT
        assert need == net_group_smem_bytes("exact", L, 3, 3, 48, tile, kc.pe_split, pe, 32)
