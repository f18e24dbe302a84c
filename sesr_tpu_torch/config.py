"""Hardware datapath configuration and the model/task registry.

The same immutable records as the JAX package's ``sesr_tpu/config.py``:
the bit widths of the simulated 4-PE INT8 convolution ASIC, and one
parameterized spec per task of the SESR family (after the analytic
collapse every network is a plain conv chain with one outer residual add
and an optional pixel shuffle).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareConfig:
    """Bit widths of the simulated 4-PE INT8 convolution ASIC."""

    pe: int = 4                 # number of processing elements (channel round-robin)
    quan_bits: int = 8          # INT8 weights (symmetric) / activations (asymmetric)
    bias_bits: int = 16         # fused bias clamp width (bias_int - zero*sum(W_int))
    pe_acc_bits: int = 18       # per-PE accumulator saturating width
    pe_add_bits: int = 20       # 4-PE adder-tree saturating width
    requant_bits: int = 16      # requant mantissa width
    requant_n_max: int = 32     # max right-shift for requant (mantissa * 2^-n)
    tile_width: int = 32        # hardware line-buffer tile width (export format)

    @property
    def quan_min(self) -> int:
        return -(1 << (self.quan_bits - 1))

    @property
    def quan_max(self) -> int:
        return (1 << (self.quan_bits - 1)) - 1


DEFAULT_HW = HardwareConfig()


@dataclasses.dataclass(frozen=True)
class SESRSpec:
    """Architecture of one collapsed SESR network: convs
    k=[k_first, k_block*num_lblocks, k_last], one outer residual add, and
    a pixel shuffle when ``scaling_factor`` > 1."""

    name: str
    in_channels: int
    out_channels: int
    num_channels: int = 16
    num_lblocks: int = 3
    scaling_factor: int = 1       # PixelShuffle factor; 1 = no shuffle
    tmp_channels: int = 256
    k_first: int = 5
    k_block: int = 3
    k_last: int = 5
    # sr_x2 adds a nearest-upsampled global input skip outside the model
    # (applied at scoring time, metrics.evaluate_pair)
    global_input_skip: bool = False

    @property
    def num_convs(self) -> int:
        return self.num_lblocks + 2

    @property
    def kernel_sizes(self) -> tuple:
        return (self.k_first,) + (self.k_block,) * self.num_lblocks + (self.k_last,)

    @property
    def conv_out_channels(self) -> int:
        """Output channels of the last conv (pre-PixelShuffle)."""
        return self.out_channels * self.scaling_factor ** 2

    @property
    def has_pixel_shuffle(self) -> bool:
        return self.scaling_factor > 1

    def halo_width(self) -> int:
        """Total receptive-field halo of the conv chain: sum of k//2."""
        return sum(k // 2 for k in self.kernel_sizes)


# The reference's MFLAG 1..6 task selector.
TASKS = {
    "nr": SESRSpec("nr", in_channels=3, out_channels=3),                     # MFLAG=1
    "dm": SESRSpec("dm", in_channels=3, out_channels=3),                     # MFLAG=2
    "nrdm_3": SESRSpec("nrdm_3", in_channels=3, out_channels=3),             # MFLAG=3
    "nrdm_6": SESRSpec("nrdm_6", in_channels=3, out_channels=3,
                       num_lblocks=6),                                       # MFLAG=4
    "sr_x4": SESRSpec("sr_x4", in_channels=1, out_channels=1,
                      scaling_factor=4),                                     # MFLAG=5
    "sr_x2": SESRSpec("sr_x2", in_channels=3, out_channels=3,
                      scaling_factor=2, global_input_skip=True),             # MFLAG=6
}

MFLAG_TO_TASK = {1: "nr", 2: "dm", 3: "nrdm_3", 4: "nrdm_6", 5: "sr_x4", 6: "sr_x2"}


def spec_for_task(task: str) -> SESRSpec:
    if task not in TASKS:
        raise KeyError(f"unknown task {task!r}; known: {sorted(TASKS)}")
    return TASKS[task]


# Checkpoint files shipped with the reference, per task, under its
# model_params/ (its test.py:64-69).
REFERENCE_CHECKPOINTS = {
    "nr": "nr_G.pth",
    "dm": "dm_G.pth",
    "nrdm_3": "nrdm_3_raw_G.pth",
    "nrdm_6": "nrdm_6_G.pth",
    "sr_x4": "x4sesr.pth",
    "sr_x2": "x2sesr.pth.tar",
}
