"""Plain references of the deployments the benchmark runs: plain ``torch``,
nothing of the port, for the CPU tests to hold the port against."""
