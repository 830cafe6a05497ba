from repro_torch.numerics.float_formats import (FORMATS, FloatFormat,
                                                max_finite, quantize_em,
                                                quantize_int)  # noqa: F401
