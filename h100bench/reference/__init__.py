"""Plain references of the configurations, one module a configuration's
"reference". A reference imports nothing of the program and takes nothing
the program made: only the benchmark's own operands, and the program's
outputs to judge them."""
