from tpuvdb_torch.kernels.distance import (
    l2sq_full,
    l2sq_topk,
    l2sq_topk_blockwise,
)
from tpuvdb_torch.kernels.ivf_probe import (
    ivf_candidates,
    ivf_candidates_int8,
    ivf_candidates_int8_plain,
    ivf_candidates_packed,
    ivf_candidates_packed_int8,
    ivf_candidates_packed_int8_plain,
    ivf_candidates_packed_plain,
    ivf_candidates_plain,
    ivf_probe_search,
)
from tpuvdb_torch.kernels.pq import (
    adc_scores,
    encode_pq,
    pq_topk,
    train_opq,
    train_pq,
)
from tpuvdb_torch.kernels.pq_probe import (
    pq_candidates,
    pq_candidates_plain,
    pq_probe_search,
)
from tpuvdb_torch.kernels.quant import (
    exact_rescore,
    l2sq_topk_int8,
    l2sq_topk_int8_rescored,
    quantize_batch,
    quantize_rows_np,
)
from tpuvdb_torch.kernels.scan import (
    scan_candidates,
    scan_candidates_plain,
    scan_l2sq_topk,
)
from tpuvdb_torch.kernels.topk import mask_scores, merge_topk

__all__ = [
    "adc_scores",
    "encode_pq",
    "exact_rescore",
    "ivf_candidates",
    "ivf_candidates_int8",
    "ivf_candidates_int8_plain",
    "ivf_candidates_packed",
    "ivf_candidates_packed_int8",
    "ivf_candidates_packed_int8_plain",
    "ivf_candidates_packed_plain",
    "ivf_candidates_plain",
    "ivf_probe_search",
    "l2sq_topk",
    "l2sq_topk_int8",
    "l2sq_topk_int8_rescored",
    "quantize_batch",
    "quantize_rows_np",
    "l2sq_topk_blockwise",
    "l2sq_full",
    "merge_topk",
    "mask_scores",
    "pq_candidates",
    "pq_candidates_plain",
    "pq_probe_search",
    "pq_topk",
    "train_opq",
    "train_pq",
    "scan_candidates",
    "scan_candidates_plain",
    "scan_l2sq_topk",
]
