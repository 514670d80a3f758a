"""IR benchmark harness — the BEIR-equivalent retrieval-quality subsystem
(the port of ``chamjax/ir``).

Rebuild of the reference's vendored BEIR fork (``beir/`` — SURVEY.md §2.6):
qrels-based evaluation (NDCG/MAP/Recall/P@k + custom metrics), dense exact
search as chunked fp32 matmuls on the card, ANN search backed by the
port's IVF-PQ index (the ``adc_scan_tiles`` kernel), a lexical BM25
baseline, learned sparse search, and a rerank stage.  The same surface as
the JAX package, with two renames: ``JaxDualEncoder`` is
:class:`DualEncoder` and ``JaxSparseEncoder`` is :class:`SparseEncoder`
(``nn.Module``s trained with autograd and ``torch.optim.Adam``).  The
classes that load published weights through ``transformers`` are in their
modules, as in the JAX package: ``dense.HFEncoder``,
``rerank.HFCrossEncoder`` and ``train.QueryGenerator``.
"""

from chamjax_torch.ir.dataloader import GenericDataLoader       # noqa: F401
from chamjax_torch.ir.evaluation import EvaluateRetrieval       # noqa: F401
from chamjax_torch.ir.dense import (                            # noqa: F401
    DenseRetrievalExactSearch, DenseRetrievalExactSearchMulti,
)
from chamjax_torch.ir.ann import (                              # noqa: F401
    BinarySearch, DenseRetrievalIVFPQSearch, FlatIPSearch, HNSWSearch,
    HNSWSQSearch, PCASearch, PQSearch, SQSearch,
)
from chamjax_torch.ir.lexical import BM25Search                 # noqa: F401
from chamjax_torch.ir.rerank import (                           # noqa: F401
    MaxSimReranker, Rerank, Seq2SeqReranker,
)
from chamjax_torch.ir.sparse import (                           # noqa: F401
    LearnedSparseEncoder, SparseSearch, TfidfSparseEncoder,
)
from chamjax_torch.ir.models import (                           # noqa: F401
    DualEncoder, SparseEncoder, training_pairs,
)
