"""The port's roofline model half against ``repro.roofline``.

``model_flops_for`` equals the reference's exactly for every architecture,
kind and a few batch and sequence sizes (both read ``param_count`` of the
same catalog); ``_wire_factor`` equals it for every collective opcode and
group size; ``from_stats`` gives the reference's terms, dominant term,
useful ratio and details on shared counts (the reference's ``HloStats``,
the port's ``DryStats``) and one shared hardware model, the port's H100
figures handed to the reference's ``HardwareModel``. Pure arithmetic: no
tolerance.
"""
from __future__ import annotations

import dataclasses

import pytest

from repro import configs as jconfigs
from repro import roofline as jrl
from repro.comm.types import HardwareModel as JHardwareModel
from repro_torch import configs, roofline
from repro_torch.comm.types import H100_80GB

KINDS = ("train", "prefill", "decode")
SIZES = ((1, 1), (8, 128), (256, 4096), (32, 32768))


@pytest.mark.parametrize("arch", configs.list_archs())
def test_model_flops_for_equals_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for kind in KINDS:
        for batch, seq in SIZES:
            assert roofline.model_flops_for(cfg, kind, batch, seq) == \
                jrl.model_flops_for(jcfg, kind, batch, seq)


def test_model_flops_for_llama_train_figure():
    # the issue's expected figure: 6 x 3,212,835,840 x 4096 tokens
    cfg = configs.get_config("llama3.2-3b")
    assert roofline.model_flops_for(cfg, "train", 4, 1024) == \
        6.0 * 3_212_835_840 * 4096


OPCODES = ("all-reduce", "all-reduce-start", "all-gather", "reduce-scatter",
           "all-to-all", "collective-permute", "collective-permute-start",
           "collective-broadcast")


@pytest.mark.parametrize("op", OPCODES)
def test_wire_factor_equals_reference(op):
    for n in (0, 1, 2, 3, 4, 16, 256, 512):
        assert roofline._wire_factor(op, n) == jrl._wire_factor(op, n)


STATS = ({"flops": 3.2e14, "hbm_bytes": 7.5e11, "wire_bytes": 2.5e10,
          "operand_bytes": {"all-reduce": 1.0e10, "all-gather": 5e9},
          "collective_count": 412},
         {"flops": 0.0, "hbm_bytes": 1e6, "wire_bytes": 0.0,
          "operand_bytes": {}, "collective_count": 0},
         {"flops": 1e9, "hbm_bytes": 1e3, "wire_bytes": 1e12,
          "operand_bytes": {"collective-permute": 1e12},
          "collective_count": 3})


@pytest.mark.parametrize("case", range(len(STATS)))
@pytest.mark.parametrize("peak", [None, roofline.H100_BF16_PEAK_FLOPS])
def test_from_stats_equals_reference(case, peak):
    kw = STATS[case]
    fields = dataclasses.asdict(H100_80GB)
    if peak is not None:
        fields["peak_flops"] = peak
    jhw = JHardwareModel(**fields)
    want = jrl.from_stats(jrl.HloStats(**kw), chips=256, hw=jhw,
                          model_flops=7.9e13,
                          cost={"flops": 1.0, "bytes accessed": 2.0})
    got = roofline.from_stats(roofline.DryStats(**kw), chips=256,
                              hw=H100_80GB, model_flops=7.9e13,
                              cost={"flops": 1.0, "bytes accessed": 2.0},
                              peak_flops=peak)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.row() == want.row()


def test_peak_flops_for_dtype():
    import torch

    assert roofline.peak_flops_for(torch.bfloat16, H100_80GB) == \
        roofline.H100_BF16_PEAK_FLOPS == 989e12
    assert roofline.peak_flops_for(torch.float32, H100_80GB) == \
        H100_80GB.peak_flops
    # no field was added to the hardware model: the reference's accepts it
    JHardwareModel(**dataclasses.asdict(H100_80GB))
