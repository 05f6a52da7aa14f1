"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (with the reason) where there is no CUDA
device. Run on a machine with an H100 from the repository root:
``python -m pytest -m cuda tests/test_torch_cuda.py -q``. The same checks run
at the main path's full shapes in ``chip_smoke.py``; these use the
fixture's small shapes (hd=64), in bf16 and in f32 activations.
"""

import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda
DTYPES = pytest.mark.parametrize("dtype", ["bfloat16", "float32"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    sm = chip_smoke.Smoke(torch)
    yield sm, gen, torch.device("cuda")
    sm.counters_at_rest("after the test")


@DTYPES
def test_a8_matvec_kernel(card, dtype):
    sm, gen, dev = card
    dt = getattr(torch, dtype)
    chip_smoke.check_a8(sm, [("wqkv", 768, 384, 4, True), ("w2", 384, 1024, 8, False)],
                        1, gen, dev, dt)
    chip_smoke.check_a8(sm, [("w13", 2048, 384, 4, True)], 7, gen, dev, dt)


# 2-16 rows: a8_quantize and the int8 tensor-core matvec, one n-tile (2, 8)
# and two (16): raw mode exact, fused within the limit of the plain version.
@DTYPES
@pytest.mark.parametrize("rows", [2, 8, 16])
def test_a8_matvec_mma_route(card, dtype, rows):
    sm, gen, dev = card
    chip_smoke.check_a8(sm, chip_smoke.A8_FIXTURE, rows, gen, dev, getattr(torch, dtype))


@DTYPES
def test_decode_attention_update_kernel(card, dtype):
    sm, gen, dev = card
    chip_smoke.check_decode(sm, 3, 6, 3, 256, 64, chip_smoke.DECODE_CASES_FIXTURE, gen, dev,
                            getattr(torch, dtype))


@DTYPES
@pytest.mark.parametrize("kv", ["act", "int8"])
def test_decode_attention_read_kernel(card, dtype, kv):
    sm, gen, dev = card
    chip_smoke.check_decode_read(sm, 3, 6, 3, 256, 64, chip_smoke.READ_CASES_FIXTURE, gen,
                                 dev, getattr(torch, dtype), kv)


@DTYPES
def test_flash_attention_kernel(card, dtype):
    sm, gen, dev = card
    chip_smoke.check_flash(sm, 3, 48, 6, 3, 256, 64, chip_smoke.FLASH_CASES_FIXTURE, gen, dev,
                           getattr(torch, dtype))


# The redesigned kernels at their new edges, at the 8B shapes: decode lengths
# around the chunk of SPLIT_CHUNK positions, windows starting inside a chunk,
# a serve batch that leaves most chunks dead; flash over a ragged S from
# unaligned starts.
def test_decode_attention_chunk_edges_8b(card):
    sm, gen, dev = card
    chip_smoke.check_decode(sm, 1, 32, 8, 1024, 128, chip_smoke.DECODE_CASES_8B, gen, dev)
    chip_smoke.check_decode(sm, 8, 32, 8, 1024, 128, chip_smoke.DECODE_CASES_SERVE[-1:], gen,
                            dev)


@pytest.mark.parametrize("kv", ["act", "int8"])
def test_decode_attention_read_dead_chunks_8b(card, kv):
    sm, gen, dev = card
    lengths = chip_smoke.DECODE_CASES_SERVE[-1][0]
    chip_smoke.check_decode_read(sm, 8, 32, 8, 1024, 128,
                                 [(lengths, None), (lengths, chip_smoke.SPLIT_CHUNK + 3)], gen,
                                 dev, kv=kv)


def test_flash_attention_ragged_8b(card):
    sm, gen, dev = card
    chip_smoke.check_flash(sm, 1, chip_smoke.FLASH_RAGGED_S, 32, 8, 1024, 128,
                           chip_smoke.FLASH_CASES_RAGGED, gen, dev)


# Decode, flash and paged attention, the matvec and the dequant matmul
# (split-K and tensor-core routes) twice in one CUDA graph.
def test_attention_kernels_in_a_cuda_graph(card):
    sm, gen, dev = card
    chip_smoke.check_graph_replay(sm, 2, 32, 8, 1024, 128, gen, dev)
    chip_smoke.check_graph_replay(sm, 3, 6, 3, 256, 64, gen, dev)


@DTYPES
def test_paged_attention_kernel(card, dtype):
    sm, gen, dev = card
    chip_smoke.check_paged(sm, 4, 6, 3, 64, 16, 8, chip_smoke.PAGED_CASES_FIXTURE, gen, dev,
                           getattr(torch, dtype))


# The paged kernel's chunks of 32 positions across pages of 4 (fixture
# widths), 8 and 48 (8B widths), lengths at the chunk edges.
@DTYPES
def test_paged_attention_chunks_cross_pages(card, dtype):
    sm, gen, dev = card
    chip_smoke.check_paged(sm, 4, 6, 3, 64, 4, 32, chip_smoke.PAGED_CASES_P4, gen, dev,
                           getattr(torch, dtype))


def test_paged_attention_chunk_edges_8b(card):
    sm, gen, dev = card
    chip_smoke.check_paged(sm, 8, 32, 8, 128, 8, 16, chip_smoke.PAGED_CASES_P8, gen, dev)
    chip_smoke.check_paged(sm, 8, 32, 8, 128, 48, 4, chip_smoke.PAGED_CASES_P48, gen, dev)


@DTYPES
@pytest.mark.parametrize("rows", [1, 8, 32])
def test_quant_matmul_kernel(card, dtype, rows):
    sm, gen, dev = card
    for scales in ("bfloat16", "float32"):
        chip_smoke.check_qmm(sm, chip_smoke.QMM_FIXTURE, rows, gen, dev, getattr(torch, dtype),
                             getattr(torch, scales))


@DTYPES
@pytest.mark.parametrize("rows", [1, 5, 16])
def test_ffn_block_kernel(card, dtype, rows):
    sm, gen, dev = card
    chip_smoke.check_ffn_block(sm, 384, 1024, rows, chip_smoke.FFN_CASES, gen, dev,
                               getattr(torch, dtype))


# The first launch on a device makes the arrival counters. Its workspace must
# be held until the launch: a freed one was once handed to the counters, which
# then held partials and merged every later launch early. Freed NaN blocks
# make such a fault show.
def test_decode_first_launch_keeps_its_workspace(card):
    sm, gen, dev = card
    from metalchat_tpu_torch.ops import _build

    _build._RETIRED.extend(_build._COUNTERS.values())
    _build._COUNTERS.clear()
    torch.full((1 << 24,), float("nan"), device=dev)
    chip_smoke.check_decode(sm, 3, 6, 3, 112, 64, [([49, 64, 80], None, "random")], gen, dev)
    sm.counters_at_rest("decode, first launch")
