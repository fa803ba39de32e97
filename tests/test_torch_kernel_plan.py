"""The launch plans of the port's attention kernels, on the CPU: how the
token splits cut a row's tiles (``kernels.decode.splits``), and how much
shared memory a block of the decode kernel (B1 / B5) and of the flash
kernel (B4) asks for, against what a block can have on an H100."""
import itertools

import pytest

from gear_tpu_torch.config import METHODS, CompressionConfig
from gear_tpu_torch.kernels import decode as TK
from gear_tpu_torch.kernels import flash as TF
from gear_tpu_torch.models import llama

PLAN_CASES = list(itertools.product(
    (1, 129, 300, 1930, 4400),   # tokens of a row
    (1, 16, 256),                # rows (BH)
    (132,),                      # SMs
    (0, 0.1, 2, 3, 16),          # blocks per SM
)) + [(1094, 128, 132, 3), (4416, 16, 132, 3), (3072, 256, 132, 3),
      (300, 4, 7, 1)]


@pytest.mark.parametrize("max_tiles", [None, 4])
@pytest.mark.parametrize("n_tokens,bh,sms,bps", PLAN_CASES)
def test_splits_cover_every_tile_once(n_tokens, bh, sms, bps, max_tiles):
    n_split, per = TK.splits(n_tokens, bh, sms, bps, max_tiles)
    n_tiles = -(-n_tokens // TK.TILE)
    assert 1 <= per <= (max_tiles or n_tiles)
    # split s walks tiles [s * per, min(n_tiles, (s + 1) * per)), as the
    # kernels do: every tile in exactly one split, no split empty
    owner = [s for s in range(n_split)
             for _ in range(s * per, min(n_tiles, (s + 1) * per))]
    assert owner == sorted(owner)
    assert len(owner) == n_tiles
    assert set(owner) == set(range(n_split))
    # a row is split only while the rows alone leave SMs without blocks, or
    # while a split would walk more than max_tiles tiles
    if n_split > 1 and max_tiles is None:
        assert bh * n_split <= max(bh, int(bps * sms))
    if max_tiles is not None:
        assert n_split <= max(-(-n_tiles // max_tiles),
                              TK.splits(n_tokens, bh, sms, bps)[0])


def test_splits_of_an_empty_row():
    assert TK.splits(0, 8, 132, 3) == (0, 1)


@pytest.mark.parametrize("bps,expect", [
    (0, (1, 35)),   # one block walks the whole row
    (2, (12, 3)),
    (3, (18, 2)),   # the Mistral-7B raw path: 16 rows of 4,400 tokens
    (16, (35, 1)),
])
def test_splits_at_the_mistral_path(bps, expect):
    assert TK.splits(4400, 16, 132, bps) == expect


def test_splits_cap_the_tiles_of_a_split():
    # the serving path: 256 rows, the longest of 3,072 tokens (24 tiles)
    assert TK.splits(3072, 256, 132, 3) == (1, 24)
    assert TK.splits(3072, 256, 132, 3, 4) == (6, 4)
    assert TK.splits(1094, 128, 132, 3, 4) == (3, 3)


def _decode_configs():
    """(bits, GQ, int8 bases, stored outliers, rank, V group) of every
    method of config.METHODS at head_dim 128 and group 64, as the models
    build them, with each GQ the kernels take and bases in bf16 or int8."""
    cfg = llama.ModelConfig.tiny(head_dim=128, hidden_size=256, num_heads=2,
                                 num_kv_heads=2)
    seen = set()
    for method, bits in itertools.product(METHODS, (2, 4, 8)):
        comp = CompressionConfig(num_layers=1, compress_method=method,
                                 quantize_bit=bits, group_size=64)
        spec = cfg.cache_spec(1, 256, comp)
        for gq, base8 in itertools.product(TK.GQ_SIZES, (False, True)):
            seen.add((spec.bits, gq, base8, spec.ko_store, spec.r_store,
                      spec.v_group))
    return sorted(seen)


DECODE_CONFIGS = _decode_configs()


def test_methods_give_both_outlier_layouts():
    assert {ko for _, _, _, ko, _, _ in DECODE_CONFIGS} == {0, 256}


@pytest.mark.parametrize("bits,gq,base8,ko,r,v_group", DECODE_CONFIGS)
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_block_fits_in_shared_memory(bits, gq, base8, ko, r, v_group,
                                            paged):
    smem = TK.decode_smem_bytes(gq, 128, bits, r, 64, v_group, ko, base8,
                                paged)
    stage = TK.stage_bytes(128, bits, r, 64, v_group, ko, base8)
    assert smem <= TK.SMEM_MAX
    assert smem > TK.STAGES * stage  # the ring and the working buffers
    assert stage % 16 == 0           # every stage starts on 16 bytes


def test_decode_stage_holds_the_tile():
    """int4, rank 4, 256 stored outliers: the tile's codes, sidebands,
    bases and outlier tables, nothing twice."""
    d, tile, nbt = 128, TK.TILE, 2
    codes = 16 * tile * 4 + 16 * (tile + 4) * 4
    side = 2 * 2 * tile * 2 + 2 * 4 * tile * 2 + 2 * nbt * d * 2
    bases = 2 * nbt * 4 * d * 2
    outl = 2 * nbt * (128 * 4 + 256 * 2 + 128 * 4)
    assert TK.stage_bytes(d, 4, 4, 64, 64, 256, False) == (
        codes + side + bases + outl)


@pytest.mark.parametrize("gq,bits,ko,bps", [
    (1, 4, 0, 3),     # Llama-2-7B GEARL
    (1, 4, 256, 3),   # the serving path (GEAR), with the outlier terms
    (2, 4, 256, 3),
    (4, 4, 256, 3),   # Mistral-7B GEAR: no terms' buffer, three an SM
    (4, 4, 0, 3),
    (8, 8, 256, 1),
])
def test_decode_plan_of_the_main_shapes(gq, bits, ko, bps):
    """How many blocks of the decode kernel an SM holds, which the token
    splits then aim at."""
    smem = TK.decode_smem_bytes(gq, 128, bits, 4, 64, 64, ko, False, False)
    assert TK.blocks_per_sm(smem) == bps
    if (gq, bits, ko) == (4, 4, 256):
        # the Mistral-7B path: 16 rows of 35 live tiles, in one wave
        n_split, per = TK.splits(4416, 16, 132, bps, TK.MAX_TILES)
        assert (n_split, per) == (18, 2) and 16 * (n_split + 1) <= 132 * bps


@pytest.mark.parametrize("gq", TK.GQ_SIZES)
def test_flash_blocks_fit_on_an_sm(gq):
    smem = TF.flash_smem_bytes(gq, 128)
    fit = 233472 // (smem + 1024)  # 228 KB an SM, 1 KB reserved a block
    assert fit >= (TF.BLOCKS_PER_SM if gq <= 4 else 2)
    assert smem <= TK.SMEM_MAX


def test_ptxas_usage_names_every_instantiation():
    """The build log's registers and spills by kernel and template
    arguments, the pack kernel's input type included (its float32 and bf16
    instantiations must not fold into one name)."""
    from gear_tpu_torch.kernels import _build

    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112token"
        "_kernelI13__nv_bfloat16Li4EEEvPKT_PiPfS6_lii' for 'sm_90a'",
        "ptxas info    : Used 96 registers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112token"
        "_kernelIfLi4EEEvPKT_PiPfS5_lii' for 'sm_90a'",
        "    8 bytes spill stores, 16 bytes spill loads",
        "ptxas info    : Used 90 registers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119decode"
        "_split_kernelILi4ELi1ELb0ELb1EEEvNS_6ParamsE' for 'sm_90a'",
        "ptxas info    : Used 150 registers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114channel"
        "_kernelEPKfPiPfS3_iii' for 'sm_90a'",
        "ptxas info    : Used 40 registers",
    ])
    assert _build.ptxas_usage(log) == {
        "token_kernel<bf16,4>": (96, 0, 0),
        "token_kernel<float,4>": (90, 8, 16),
        "decode_split_kernel<4,1,0,1>": (150, 0, 0),
        "channel_kernel": (40, 0, 0),
    }
