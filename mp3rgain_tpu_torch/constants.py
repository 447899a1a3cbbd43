"""The reference's state, carried across into the port's form.

This system has no learned weights; its state is the set of constant
tables behind the kernels and GEMMs. The JAX package builds them in numpy
(entropy_kernel._luts_packed, hybrid_kernel._consts / natural_cores,
synthesis._tail_matrices_fused, iir._group_kernels / _prefix_kernels);
the port has copies of those builders and turns their arrays into the
buffers of parallel.runner.LightTail:

  - the int8 offset one-hot LUT packs become plain (groups, windows, 2)
    int32 tables (luts_from_packed);
  - the one-hot slot (3, 64, 576) and win (3, 3, 576) expansions, and
    the host-decoded route's short-layout reorder, become int32 index
    tables, -1 meaning none (onehot_to_index); for K2 the slot and win
    indices, pretab, short flag and band start are also packed into one
    int32 word per (class, sample) (hybrid_kernel.pack_class_words);
  - GEMM constants become float32, the IIR constants stay float64 (cast
    to the filtered signal's dtype at use); the host-decoded route's
    class cores are split once into bf16 hi/lo pairs for K3
    (decode_state).

from_jax_arrays does that for arrays handed over from the JAX package's
own builders; LightTail builds the same buffers from the port's copies,
and the tests hold the two equal, buffer by buffer.
"""

from __future__ import annotations

import numpy as np
import torch

PACK_NAMES = ("lutA_T", "lutB_T", "lutC_T", "lutCT_T")
CONSTS_NAMES = ("slot", "win", "pretab", "band_start", "short")
DECODE_NAMES = ("core_l", "core_s", "core_m", "wins", "na", "nb")


def luts_from_packed(packs) -> dict[str, np.ndarray]:
    """int8 packs ((2*groups, windows), values stored offset by -128, the
    two fields of group g in rows 2g, 2g+1) → (groups, windows, 2) int32
    [ab, field] tables keyed lut_a, lut_b, lut_c, lut_ct."""
    from .decode.entropy_kernel import LUT_NAMES

    out = {}
    for name, pack in zip(LUT_NAMES, packs):
        rows, win = pack.shape
        vals = pack.astype(np.int32) + 128
        out[name] = np.ascontiguousarray(
            vals.reshape(rows // 2, 2, win).transpose(0, 2, 1)
        )
    return out


def onehot_to_index(onehot: np.ndarray) -> np.ndarray:
    """(C, K, N) one-hot columns → (C, N) int32 row index of each column's
    1, or -1 where a column is all zero. `x @ onehot[c]` then equals
    x[:, index[c]] (0 where -1) exactly."""
    oh = np.asarray(onehot)
    nz = oh != 0
    if (nz.sum(axis=1) > 1).any() or not np.all(oh[nz] == 1):
        raise ValueError("not a one-hot expansion")
    idx = nz.argmax(axis=1)
    return np.where(nz.any(axis=1), idx, -1).astype(np.int32)


def hybrid_state(arrays: dict, sr_row: int) -> dict[str, torch.Tensor]:
    """HybridTables buffers from _consts and natural_cores arrays, and the
    hybrid synthesis kernel's compact constants of sample-rate row sr_row
    (hybrid_kernel.synthesis_consts, which the JAX package has no
    counterpart of; the tests hold them to natural_cores)."""
    from .decode.hybrid_kernel import (is_ratio_table, pack_class_words,
                                       synthesis_consts)

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))

    slot_idx = onehot_to_index(arrays["slot"])
    win_idx = onehot_to_index(arrays["win"])
    syn = synthesis_consts(sr_row)
    return {
        "slot_idx": torch.from_numpy(slot_idx),
        "win_idx": torch.from_numpy(win_idx),
        "pretab": f32(arrays["pretab"]),
        "band_start": f32(arrays["band_start"]),
        "short": f32(arrays["short"]),
        "class_words": torch.from_numpy(pack_class_words(
            slot_idx, win_idx, arrays["pretab"], arrays["band_start"],
            arrays["short"])),
        "is_ratio": torch.from_numpy(is_ratio_table().copy()),
        "cores2": f32(arrays["cores2"]),
        "head": f32(arrays["head"]),
        "wins": f32(arrays["wins"]),
        "syn_maps": f32(syn["maps"]),
        "syn_wins": f32(syn["wins"]),
        "syn_alias": f32(syn["alias"]),
        "syn_perms": torch.from_numpy(syn["perms"].copy()),
    }


def decode_state(sr_row: int, core_l, core_s, core_m, wins, na,
                 nb) -> dict[str, torch.Tensor]:
    """decode.synthesis.DecodeTables buffers for one sample-rate row, from
    the layout-order class cores and long windows of _fused_hybrid_cores
    and the polyphase maps of _tail_matrices_fused (the port's copies or
    the JAX package's, which are equal):

      class_of_kind (5,) int32    layout class of each block kind
      perm_short (576,) int32     short-layout reorder, x[..., perm_short]
      slot_idx, win_idx (3, 576)  scalefactor / subblock-gain index per
                                  layout class (row_tables' one-hots)
      pretab, is_short (3, 576) f32, band_start (3, 576) int32
      chi, clo (3, 576, 1152) bf16  long/short/mixed cores, split once
      wins (4, 1152) f32, synth_na, synth_nb (576, 576) f32
      synth_n (64, 32), synth_d (16, 32) f32  matrixing and dewindow
                                  taps of the polyphase kernel (the
                                  port's tables.build_tables)"""
    from .decode.class_core import split_bf16
    from .decode.tables import CLASS_OF_KIND, build_tables, row_tables

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))

    rt = row_tables(sr_row)
    cores = f32(np.stack([core_l, core_s, core_m]).astype(np.float32))
    chi, clo = split_bf16(cores)
    return {
        "class_of_kind": torch.from_numpy(CLASS_OF_KIND.astype(np.int32)),
        "perm_short": torch.from_numpy(onehot_to_index(rt.perm_short_onehot.T[None])[0]),
        "slot_idx": torch.from_numpy(onehot_to_index(rt.slot_onehot)),
        "win_idx": torch.from_numpy(onehot_to_index(rt.win_onehot)),
        "pretab": f32(rt.pretab),
        "band_start": torch.from_numpy(rt.band_start.astype(np.int32)),
        "is_short": f32(rt.is_short),
        "chi": chi,
        "clo": clo,
        "wins": f32(wins),
        "synth_na": f32(na),
        "synth_nb": f32(nb),
        "synth_n": f32(build_tables().synth_n),
        "synth_d": f32(build_tables().synth_d),
    }


def from_jax_arrays(arrays: dict[str, np.ndarray], sample_rate: int,
                    n_channels: int, device) -> dict[str, torch.Tensor]:
    """LightTail(sample_rate, n_channels) state dict from the JAX
    builders' arrays:

      lutA_T, lutB_T, lutC_T, lutCT_T   entropy_kernel._luts_packed()[:4]
      slot, win, pretab, band_start, short
                                        hybrid_kernel._consts(sr_row)
      cores2, head, wins                hybrid_kernel.natural_cores(sr_row)
      core_l, core_s, core_m, wins      synthesis._fused_hybrid_cores()
      na, nb                            synthesis._tail_matrices_fused()
      iir.s{i}_{tc,g,t2m,p,ml2}         iir._group_kernels(...)[:2] and
                                        iir._prefix_kernels(..., None, 128)
                                        per stage of iir.stage_plan

    (natural_cores' and _fused_hybrid_cores' wins are the same array.)
    Load the result with LightTail.load_state_dict."""
    from .decode.format_tables import SR_ROW
    from .ops.iir import stage_plan

    if n_channels not in (1, 2):
        raise ValueError(f"n_channels {n_channels}")
    n_stages = len(stage_plan(sample_rate))
    state = {}
    for name, table in luts_from_packed([arrays[k] for k in PACK_NAMES]).items():
        state[f"luts.{name}"] = torch.from_numpy(table)
    for name, t in hybrid_state(arrays, SR_ROW[sample_rate]).items():
        state[f"hybrid.{name}"] = t
    decode = decode_state(SR_ROW[sample_rate], *(arrays[k] for k in DECODE_NAMES))
    for name, t in decode.items():
        state[f"decode.{name}"] = t
    for key, arr in arrays.items():
        if key.startswith("iir."):
            if int(key[5:].split("_")[0]) >= n_stages:
                raise ValueError(f"{key}: rate {sample_rate} has {n_stages} stages")
            state[key] = torch.from_numpy(np.array(arr, dtype=np.float64))
    return {k: v.to(device) for k, v in state.items()}
