"""device.idle_pct.gate: device.idle_pct in the gate cell, where it moves
pair_p95_ms."""

from portbench.harness import load_reader

read = load_reader("device.idle_pct")
