"""What every cell of the benchmark shares: the card's peaks, operation and
byte counts, the reduction of a trace to busy time and idle gaps, the
percentile rule, the weights and inputs made from the seed, and the
closed loop that runs a cell."""
