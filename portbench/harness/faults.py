"""Faults planted under a rehearsal run's timed path, so that a test can
see ``correct`` come out false (``--rehearse-fault``; no check passes it).

* ``unchanged``: a scoring batch returns with the workload's state as it
  was (nothing indexed, scored or linked);
* ``half``: half of each batch's queries are left out of the scoring
  pass (the index still takes them all);
* ``alter``: every confidence the host computes is altered where it is
  produced, by one part in a billion;
* ``volatile``: the workload acknowledges and serves its links from
  memory, and nothing reaches its data folder.
"""


def plant(fault, system):
    proc = system.workload.processor
    if fault == "unchanged":
        def unchanged(records):
            # still recorded, as the arrival order the reference reads
            system.batches.append([r.record_id for r in records])

        proc.deduplicate = unchanged
    elif fault == "half":
        score = proc._score_blocks

        def half(records):
            return score(list(records)[: len(records) // 2])

        proc._score_blocks = half
    elif fault == "alter":
        compare = proc.compare

        def altered(r1, r2):
            return compare(r1, r2) * (1.0 + 1e-9)

        proc.compare = altered
    elif fault == "volatile":
        from sesam_duke_microservice_tpu_torch.links import (
            InMemoryLinkDatabase)

        system.workload.replace_link_database(InMemoryLinkDatabase())
    else:
        raise ValueError(fault)
