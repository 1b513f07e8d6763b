"""Multi-rank paths on ``torch.distributed`` (port of ``dvo_slam_tpu.parallel``).

``mesh`` and ``distributed`` set up the process group and the rank's
place in it; ``sharded_alignment`` runs one alignment sharded over pixels
(two all-reduces per iteration) or a wave of alignments sharded over pairs;
``multistream`` tracks B camera streams in lockstep (or one after another),
their streams sharded over the ranks; ``temporal`` cuts one long stream
into chunks that it tracks as such streams.
"""

from .mesh import BATCH_AXIS

__all__ = ["BATCH_AXIS"]
