"""Hand-written CUDA kernels (csrc/) with their plain PyTorch versions."""


def _wrappers() -> dict:
    from . import decode, flash, flush, pack

    return {
        "decode_attention": decode.decode_attention,
        "decode_attention_mma": decode.mma_products,
        "decode_attention_paged": decode.decode_attention_paged,
        "flash_decode": flash.flash_decode,
        "flush": flush.flush,
        "quant_pack_channels": pack.quant_pack_channels,
        "quant_pack_tokens": pack.quant_pack_tokens,
    }


def launch_counts() -> dict[str, int]:
    """Calls of each hand-written kernel's launching wrapper since the last
    reset: those kernels only (``decode_attention_mma``: the decode
    launches, dense or paged, that took the tensor-core products). The launches a decode step makes on the
    card, library kernels, copies and fills included, are its device
    records in a ``torch.profiler`` trace."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def add_launch_counts(counts: dict[str, int]) -> None:
    """Add ``counts`` (by wrapper name) to the wrappers' counts: the
    launches of a CUDA graph's replay, which no wrapper call makes."""
    wrappers = _wrappers()
    for name, n in counts.items():
        wrappers[name].launches += n
