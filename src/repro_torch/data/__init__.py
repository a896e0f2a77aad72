"""The LOG.io-protected training feed: the port's copy of ``repro.data``
(numpy only, so it gives the same batches for the same seed)."""
from repro_torch.data.pipeline import (BatchOperator, SyntheticCorpus,
                                       TrainFeedSink, build_data_pipeline,
                                       pack_fn)
