"""The benchmark's yardstick for the hand-written kernels: the operations
and bytes each piece of work needs, computed from its shapes, and the map
from the kernels the device trace names to that work."""
