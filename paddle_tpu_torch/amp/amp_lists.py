"""The amp op lists (the JAX package's ``AMP_WHITE_OPS``/``AMP_BLACK_OPS``
in ``paddle_tpu/core/dispatch.py``, copied as they are).

Names are the JAX package's op names, which the port's functionals pass
to ``amp_cast``. Under O1/O2 a white-list op's floating inputs go to the
amp dtype, a black-list op's to fp32; every other op is left alone.
"""

AMP_WHITE_OPS = {
    "matmul", "mm", "bmm", "conv2d", "conv1d", "conv3d", "conv2d_transpose",
    "einsum", "linear", "addmm", "flash_attention", "scaled_dot_product_attention",
    # chunked head+loss fusion: the matmul dominates, internal lse math
    # accumulates in f32 regardless of the input dtype
    "fused_linear_cross_entropy",
    # GEMM-bearing fused ops (compile/fusion): the norm prologue /
    # rope epilogue compute in f32 internally regardless of input dtype
    "fused_norm_linear", "fused_rope_proj",
}
AMP_BLACK_OPS = {
    "exp", "log", "log2", "log10", "log1p", "pow", "square", "sqrt", "rsqrt",
    "softmax", "log_softmax", "cross_entropy", "softmax_with_cross_entropy",
    "layer_norm", "rms_norm", "batch_norm", "group_norm", "instance_norm",
    "mean", "sum", "cumsum", "sigmoid_cross_entropy", "reduce_sum",
    "norm", "cos_sim", "erfinv", "acos", "asin", "atan2",
}

__all__ = ["AMP_WHITE_OPS", "AMP_BLACK_OPS"]
