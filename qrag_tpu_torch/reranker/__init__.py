from qrag_tpu_torch.reranker.classical import ClassicalReranker
from qrag_tpu_torch.reranker.quantum import QuantumReranker
from qrag_tpu_torch.reranker.controller import RerankerController, rerank_response_dict

__all__ = [
    "ClassicalReranker",
    "QuantumReranker",
    "RerankerController",
    "rerank_response_dict",
]
