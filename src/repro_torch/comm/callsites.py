"""Central registry of collective callsite tags.

The port's own copy of ``repro/comm/callsites.py``: the same tag strings and
metadata, so a measurement keyed ``op@callsite`` means the same call pattern
in both packages. ``module`` still names the reference module that owns the
call; the port's owner is the module of the same path under ``repro_torch``.
Import-free on purpose (no torch, no siblings).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

# -- tag constants (import these at callsites; never inline the strings) ----

HPL_BLOCK = "hpl.block"          # HPL diagonal-block bcast (torus row/col)
HPL_PANEL = "hpl.panel"          # HPL panel bcast, dependent on the block
PTRANS_EXCHANGE = "ptrans.exchange"  # PTRANS grid-transpose partner swap
MOE_DISPATCH = "moe.dispatch"    # MoE token->expert all-to-all
MOE_COMBINE = "moe.combine"      # MoE expert->token inverse all-to-all
DP_GRADS = "dp.grads"            # bucketed data-parallel gradient allreduce
TP_QKV = "tp.qkv"                # head-parallel attention: q/k/v head split
TP_OUT = "tp.out"                # head-parallel attention: inverse exchange
SP_QKV = "sp.qkv"                # ring attention: q/k/v sequence split
SP_KV = "sp.kv"                  # ring attention: per-step kv block rotation
SP_OUT = "sp.out"                # ring attention: inverse exchange
DECODE_QKV = "decode.qkv"        # per-token decode: q/k/v head split
DECODE_OUT = "decode.out"        # per-token decode: inverse head exchange
DECODE_MOE = "decode.moe"        # per-token decode: MoE dispatch+combine
RA_UPDATES = "ra.updates"        # GUPS: route updates to owning ranks
FFT_TRANSPOSE = "fft.transpose"  # pencil FFT: signal gather/scatter a2a


@dataclass(frozen=True)
class Callsite:
    """Metadata for one tagged engine call.

    ``op``      the engine op issued under this tag.
    ``module``  the dotted module that owns the call (imports the constant).
    ``const``   the constant's symbol name in this module.
    ``tuned``   the ``op@callsite`` autotune pattern key whose measured
                winner covers this tag (a paired tag names its pair's
                key); ``None`` means lookups fall back to the untagged op
                entry.
    """
    op: str
    module: str
    const: str
    tuned: Optional[str] = None


CALLSITES: Dict[str, Callsite] = {
    HPL_BLOCK: Callsite("bcast", "repro.core.hpl", "HPL_BLOCK"),
    HPL_PANEL: Callsite("bcast", "repro.core.hpl", "HPL_PANEL",
                        tuned="bcast@hpl.panel"),
    PTRANS_EXCHANGE: Callsite("grid_transpose", "repro.core.ptrans",
                              "PTRANS_EXCHANGE"),
    MOE_DISPATCH: Callsite("all_to_all_tiles", "repro.models.moe",
                           "MOE_DISPATCH",
                           tuned="all_to_all_tiles@moe.dispatch"),
    MOE_COMBINE: Callsite("all_to_all_tiles", "repro.models.moe",
                          "MOE_COMBINE",
                          tuned="all_to_all_tiles@moe.dispatch"),
    DP_GRADS: Callsite("allreduce", "repro.train.step", "DP_GRADS"),
    TP_QKV: Callsite("all_to_all_tiles", "repro.models.parallel", "TP_QKV",
                     tuned="all_to_all_tiles@tp.qkv"),
    TP_OUT: Callsite("all_to_all_tiles", "repro.models.parallel", "TP_OUT",
                     tuned="all_to_all_tiles@tp.qkv"),
    SP_QKV: Callsite("all_to_all_tiles", "repro.models.parallel", "SP_QKV",
                     tuned="all_to_all_tiles@sp.qkv"),
    SP_KV: Callsite("ring_exchange", "repro.models.parallel", "SP_KV"),
    SP_OUT: Callsite("all_to_all_tiles", "repro.models.parallel", "SP_OUT",
                     tuned="all_to_all_tiles@sp.qkv"),
    DECODE_QKV: Callsite("all_to_all_tiles", "repro.models.parallel",
                         "DECODE_QKV",
                         tuned="all_to_all_tiles@decode.qkv"),
    DECODE_OUT: Callsite("all_to_all_tiles", "repro.models.parallel",
                         "DECODE_OUT",
                         tuned="all_to_all_tiles@decode.qkv"),
    DECODE_MOE: Callsite("all_to_all_tiles", "repro.train.serve",
                         "DECODE_MOE",
                         tuned="all_to_all_tiles@decode.qkv"),
    RA_UPDATES: Callsite("all_to_all_tiles", "repro.core.randomaccess",
                         "RA_UPDATES",
                         tuned="all_to_all_tiles@ra.updates"),
    FFT_TRANSPOSE: Callsite("all_to_all_tiles", "repro.core.fft",
                            "FFT_TRANSPOSE",
                            tuned="all_to_all_tiles@fft.transpose"),
}
