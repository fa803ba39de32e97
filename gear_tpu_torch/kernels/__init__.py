"""Hand-written CUDA kernels (csrc/) with their plain PyTorch versions."""


def _wrappers() -> dict:
    from . import decode, flash, pack

    return {
        "decode_attention": decode.decode_attention,
        "decode_attention_paged": decode.decode_attention_paged,
        "flash_decode": flash.flash_decode,
        "quant_pack_channels": pack.quant_pack_channels,
        "quant_pack_tokens": pack.quant_pack_tokens,
    }


def launch_counts() -> dict[str, int]:
    """Launches of every kernel wrapper since the last reset."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
