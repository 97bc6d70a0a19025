"""The plain reference the benchmark judges the program against.

Plain torch and numpy, float64 (the reference) or TF32 (the control: every
operand rounded to TF32's 10-bit mantissa, sums in float32, as a TF32
tensor-core product takes them). It imports nothing of `common_tpu_torch`,
`common_tpu` or JAX, and takes from the program only the outputs it judges.
"""
