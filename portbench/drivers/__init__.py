"""Traffic drivers: the program's entry points that one kind of traffic calls, one file per driver."""
