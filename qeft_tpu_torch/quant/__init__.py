"""GPTQ-OWQ quantization of the PyTorch port: the affine quantizer, the
weak-column selection, the OGR index math and the GPTQ reconstruction.
Counterpart of ``qeft_tpu/quant``."""

from qeft_tpu_torch.quant.gptq import LayerQuantResult, gptq_quantize, hessian_from_inputs
from qeft_tpu_torch.quant.outliers import hessian_sort_ids, select_global_outliers
from qeft_tpu_torch.quant.quantizer import (
    QuantParams,
    QuantSpec,
    fake_quantize,
    find_params,
    quantize,
)
from qeft_tpu_torch.quant.reorder import inverse_permutation, sparse_to_dense_ids

__all__ = ["LayerQuantResult", "QuantParams", "QuantSpec", "fake_quantize", "find_params",
           "gptq_quantize", "hessian_from_inputs", "hessian_sort_ids", "inverse_permutation",
           "quantize", "select_global_outliers", "sparse_to_dense_ids"]
