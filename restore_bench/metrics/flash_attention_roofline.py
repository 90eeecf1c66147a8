"""Share of the attention kernel's roofline: the frozen bound of every
recorded call over the device time of the forward kernels (and the
split form's merge) in the trace (%)."""
from ._common import roofline_pct
from ..yardstick.kernel_cost import attention_s


def read(run):
    return roofline_pct(run, "flash_attention",
                        ("fa_sm90_kernel", "fa_merge_kernel",
                         "flash_attention_kernel"), attention_s)
