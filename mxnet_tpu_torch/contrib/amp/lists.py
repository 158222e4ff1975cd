"""AMP op lists (counterpart of ``mxnet_tpu/contrib/amp/lists.py``; ref:
python/mxnet/contrib/amp/lists/symbol_fp16.py :: FP16_FUNCS / FP32_FUNCS /
WIDEST_TYPE_CASTS). Names the port does not register yet are kept: a
call of one raises before any cast matters."""

# compute-heavy: run in the low-precision dtype
FP16_FUNCS = [
    "FullyConnected",
    "Convolution",
    "Deconvolution",
    "dot",
    "batch_dot",
    "linalg_gemm2",
    "RNN",
    "_contrib_interleaved_matmul_selfatt_qk",
    "_contrib_interleaved_matmul_selfatt_valatt",
    "_contrib_interleaved_matmul_encdec_qk",
    "_contrib_interleaved_matmul_encdec_valatt",
    # the fused Dense epilogues: classified with FullyConnected so the
    # bias takes the same low-precision dtype as the product it follows
    # (the kernels take matching dtypes and compute in f32 inside)
    "_contrib_bias_gelu",
    "_contrib_bias_add_residual",
]

# precision-sensitive: force float32
FP32_FUNCS = [
    "softmax",
    "log_softmax",
    "softmin",
    "SoftmaxOutput",
    "softmax_cross_entropy",
    "L2Normalization",
    "norm",
    "exp",
    "log",
    "log2",
    "log10",
    "log1p",
    "expm1",
    "erf",
    "erfinv",
    "gamma",
    "gammaln",
    "smooth_l1",
]

# run in either dtype, no cast (the norm layers compute their statistics
# in f32 inside)
FP16_FP32_FUNCS = [
    "BatchNorm",
    "LayerNorm",
    "InstanceNorm",
    "GroupNorm",
    "Activation",
    "LeakyReLU",
    "Pooling",
    "Dropout",
    "mean",
    "sum",
    "square",
    "sqrt",
    "rsqrt",
    "cbrt",
    "Reshape",
    "Flatten",
    "transpose",
    "slice",
    "slice_axis",
    "expand_dims",
]

# elementwise combiners: every input cast to the widest input dtype
WIDEST_TYPE_CASTS = [
    "broadcast_add",
    "broadcast_sub",
    "broadcast_mul",
    "broadcast_div",
    "broadcast_maximum",
    "broadcast_minimum",
    "broadcast_power",
    "elemwise_add",
    "elemwise_sub",
    "elemwise_mul",
    "elemwise_div",
    "where",
    "Concat",
    "stack",
]
