"""SIP filters of the driven side in the window that ranked the block's
bounds and ids against the side's index, over all SIP filters, in %: the
program's `driven.sip:indexed` and `driven.sip:scanned` counters. None
where the program counts no filter."""
from portbench import program_spans


def read(w):
    indexed = program_spans._counted(w, "driven.sip:indexed")
    scanned = program_spans._counted(w, "driven.sip:scanned")
    return 100.0 * indexed / (indexed + scanned) if indexed + scanned \
        else None
