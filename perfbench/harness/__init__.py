"""The benchmark's general machinery: finding cells, configurations,
traffic mixes and metrics by name, making seeded inputs, counting
operations and bytes, reading traces and printing the result line."""
