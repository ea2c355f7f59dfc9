"""A/B experiments of kernel designs on the H100, one module per TPU
experiment script of scripts/ (same name, same question, same default
sizes):

    python -m e2fgvi_tpu_torch.experiments.exp_dcn_inner_r04 [base bf16 cbatch packed]
    python -m e2fgvi_tpu_torch.experiments.exp_dcn_pack [band] [B]
    python -m e2fgvi_tpu_torch.experiments.exp_gather [v1 v2 v2b v3]
    python -m e2fgvi_tpu_torch.experiments.exp_attn_band_r04

Importing a module does no work: it reads no arguments, sets no
environment variable and touches no device. Each `main(argv=None)` parses
its arguments, raises when CUDA is absent, prints its lines and returns
what it measured as a dict. Times are medians of CUDA-event timings.
"""
