"""The window attention's share of the device's busy time: the device
seconds of the attention kernels, forward and backward, over the seconds
in which some device operation ran in the traced window, in %.  The
kernels are those ``F.scaled_dot_product_attention`` launches on the H100
for Swin UNETR's windows (names confirmed in its traces)."""

#: substrings of the attention kernels' names: PyTorch's memory-efficient
#: (CUTLASS fmha) forward and backward, and its flash and cuDNN kernels
ATTENTION_KERNELS = ("fmha_cutlass", "flash_fwd", "flash_bwd",
                     "cudnn_generated_fort_native_sdpa")


def read(trace):
    busy = trace.busy_s(0.0, trace.window_s)
    attn = [b - a for n, a, b in trace.device_ops
            if any(k in n for k in ATTENTION_KERNELS)]
    if not attn or busy <= 0:
        return None
    return 100.0 * sum(attn) / busy
