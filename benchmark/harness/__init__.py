"""The harness: finds a cell's files by name, builds the system under test,
times the window, reads the trace and decides `correct`."""
