"""Multi-query and (later) multi-device execution programs. Only the
inter-query batched predicate (`spmd.batched_predicate_masks`) lives
here so far; mesh distribution is not part of this package."""
