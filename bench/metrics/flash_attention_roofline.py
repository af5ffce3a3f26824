"""flash_attention_roofline: the flash kernel's calls (admission
prefills) in the traced stretch, their least time at the card's peaks
over the kernel's device time by name, in percent."""
from bench.lib import trace as T


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    return T.roofline_share(tr.kernels, tr.calls, "flash_attention")
