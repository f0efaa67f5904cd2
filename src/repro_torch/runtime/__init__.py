"""Runtime support of the port: the straggler watchdog."""
