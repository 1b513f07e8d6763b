"""Share of the window's matched frames, outside the profiled slice, whose
``dvo.update`` span holds a ``dvo.match.graph`` span: the match ran as one
launch of a match graph (``irls_graph.MatchGraph``) and not level by level.
None where the program records no span (``spans``) or has no match graph
(its ``irls_graph.stats()`` counts no ``match_graph_launches``)."""
from slam_bench import spans

spans.arm()


def _has_match_graphs() -> bool:
    from dvo_slam_tpu_torch.models import irls_graph

    return "match_graph_launches" in irls_graph.stats()


def read(run):
    if not _has_match_graphs():
        return None
    frames = [f for f in spans.untraced(run)
              if f.record.info.get("levels") and "dvo.update" in f.count]
    if not frames:
        return None
    return sum("dvo.match.graph" in f.count for f in frames) / len(frames)
