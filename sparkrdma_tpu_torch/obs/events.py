"""Flight-recorder event registry: THE single declaration of every
structured event name the recorder may emit, grouped by plane.

Every ``fr_event(plane, name, ...)`` call site in the tree must name a
plane and event declared here — enforced statically by tools/lint.py
rule PY12 (the PY11 conf-drift shape applied to events), so the names
``tools/trace_report.py`` renders can never silently diverge from what
the code emits.  Add the declaration FIRST, then the call site.
"""

#: plane -> tuple of event names (the recorder keeps one bounded ring
#: per plane; see obs/recorder.py)
EVENTS = {
    "transport": (
        "stripe_land",        # one stripe/block landed in its dest row
        "wire_send",          # a read request hit the wire
        "serve_admit",        # serve dequeued + credits granted
        "serve_read",         # blocks resolved from store/tier
        "serve_send",         # response frame handed to the socket
        "version_downgrade",  # connector re-helloed at the peer's version
        "wire_reject",        # wiredbg rejected a frame/header
    ),
    "reader": (
        "fetch_enqueue",      # fetch group queued behind the window
        "fetch_issue",        # fetch group issued to its read group
        "fetch_land",         # fetch group fully landed
        "fetch_retry",        # in-task retry scheduled
        "fetch_fail",         # fetch group failed terminally
        "decode_wait",        # reader blocked on a decode ticket
        "consume_wait",       # reader blocked on the results queue
        "merged_enqueue",     # push mode: one merged span planned
        "merged_fallback",    # merged fetch failed -> provenance re-pulled
    ),
    "decode": (
        "credit_wait",        # decode worker waited for pool credits
        "decode_done",        # one block decoded
        "ticket_steal",       # consumer stole the decode from the pool
    ),
    "tier": (
        "promote",            # block promoted disk -> memory
        "demote",             # block demoted memory -> disk
        "disk_read",          # serve resolved a block from disk tier
        "warm",               # prefetch-hint warm executed
    ),
    "qos": (
        "credit_block",       # admission blocked on the credit broker
    ),
    "faults": (
        "fault_fired",        # injected fault fired at a point
        "breaker_trip",       # circuit breaker CLOSED -> OPEN
        "breaker_probe",      # half-open probe issued
        "ledger_leak",        # resource ledger found leaked resources
    ),
    "state": (
        "transition",         # validated lifecycle state transition
        "illegal",            # transition absent from the declared table
    ),
}


def is_declared(plane: str, event: str) -> bool:
    """True when ``event`` is a declared event of ``plane``."""
    return event in EVENTS.get(plane, ())
