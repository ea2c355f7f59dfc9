"""Share of its roofline of the Wan DiT's self-attention over all S
tokens: the work these videos need (harness/work_wan_vace.py: 4 S^2 dim a
call at the bf16 peak, against q, k, v and o once at HBM bandwidth) over
the device time of every kernel launched inside the harness's range
`perfbench.dit_attn` around `wan_dit.self_attention`; read in the vace
cell (`.vace` is its name there)."""

from harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "dit_attn")
