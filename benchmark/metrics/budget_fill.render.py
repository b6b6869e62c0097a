"""How full the frame's static passing budget runs, in %: 100 x the
passing samples kept (a chunk's min(demand, budget)) over the passing
budgets, summed over the window's chunks (the program's counters
``budget.render``, from the rows each frame reads back). Nothing is read
where the program keeps no such counters."""
from benchmark.spans import budget_fill, program_record


def read(r):
    return budget_fill(program_record(), "budget.render")
