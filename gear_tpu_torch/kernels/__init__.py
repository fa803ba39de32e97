"""Hand-written CUDA kernels (csrc/) with their plain PyTorch versions."""


def launch_counts() -> dict[str, int]:
    """Launches of every kernel wrapper since the last reset."""
    from . import decode, pack

    return {
        "decode_attention": decode.decode_attention.launches,
        "quant_pack_channels": pack.quant_pack_channels.launches,
        "quant_pack_tokens": pack.quant_pack_tokens.launches,
    }


def reset_launch_counts() -> None:
    from . import decode, pack

    decode.decode_attention.launches = 0
    pack.quant_pack_channels.launches = 0
    pack.quant_pack_tokens.launches = 0
