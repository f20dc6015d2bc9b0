"""Ternary sparse container formats (logical and device-physical layouts)."""

from ternary_spgemm_tpu.formats.base import TernaryFormat, all_formats, register_format
from ternary_spgemm_tpu.formats.bitplane import (TiledBitplane,
    TiledNibblePair, bitplane_rowmap)
from ternary_spgemm_tpu.formats.blocked import BlockedTCSC, InterleavedBlockedTCSC
from ternary_spgemm_tpu.formats.blocked_ell import BlockedEllTCSC
from ternary_spgemm_tpu.formats.ell import EllTCSC
from ternary_spgemm_tpu.formats.ell_deposit import TiledEllDeposit, deposit_rowmap
from ternary_spgemm_tpu.formats.ell_tiled import TiledEllTCSC
from ternary_spgemm_tpu.formats.generate import (
    generate_alpha,
    generate_bias,
    generate_ternary,
    generate_x,
)
from ternary_spgemm_tpu.formats.interleaved import InterleavedTCSC
from ternary_spgemm_tpu.formats.packed import (
    BlockPackedTernary,
    DenseTernary,
    PackedCSC,
    PackedTernary2Bit,
    PackedTernary53,
    pack_signs_base3,
    unpack_signs_base3,
)
from ternary_spgemm_tpu.formats.tcsc import TCSC, TCSR
from ternary_spgemm_tpu.formats.tiled import TiledBlockPacked, TiledDenseTernary

__all__ = [
    "TernaryFormat", "all_formats", "register_format",
    "TCSC", "TCSR", "BlockedTCSC", "BlockedEllTCSC", "InterleavedBlockedTCSC",
    "InterleavedTCSC",
    "EllTCSC", "PackedCSC", "PackedTernary2Bit", "PackedTernary53",
    "BlockPackedTernary", "DenseTernary", "TiledBlockPacked",
    "TiledDenseTernary", "TiledEllTCSC", "TiledBitplane", "TiledNibblePair",
    "bitplane_rowmap",
    "TiledEllDeposit", "deposit_rowmap",
    "pack_signs_base3", "unpack_signs_base3",
    "generate_ternary", "generate_x", "generate_bias", "generate_alpha",
]
