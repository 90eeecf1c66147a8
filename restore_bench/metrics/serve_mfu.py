"""Model FLOPs of every token prefilled and decoded in the traced window
(yardstick/model_flops.py, attention from the recorded calls) over the
window times the H100's bf16 peak (%)."""
from ..yardstick import model_flops
from ..yardstick.kernel_cost import attention_flops
from ..yardstick.peaks import BF16_FLOPS


def read(run):
    t = run.trace
    if t is None or t["window_s"] <= 0:
        return None
    c = run.config
    n_dec = sum(1 for n, _, _ in run.spans if n == "model.decode_step")
    n_pre = run.counters.get("prefill_calls", 0)
    toks = run.counters.get("prefill_tokens", 0) + n_dec
    flops = toks * model_flops.token_flops(c) \
        + (n_pre + n_dec) * model_flops.head_flops(c)
    for b, hq, _, sq, d, dv, kvl, qo, causal, _ in run.calls.get(
            "flash_attention", []):
        flops += attention_flops(b, hq, sq, d, dv, kvl, qo, causal)
    return 100.0 * flops / (t["window_s"] * BF16_FLOPS)
