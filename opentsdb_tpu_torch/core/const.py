"""Wire-format constants.

Mirrors ``opentsdb_tpu/core/const.py`` of the JAX package, copied rather
than imported: the port imports nothing of that package.

Parity with reference src/core/Const.java:19-41. These values are load-bearing:
they pin the on-disk/row-key format so ``tsdb scan --import`` output from the
reference round-trips through this framework.
"""

# Number of bytes on which a (base) timestamp is encoded inside a row key.
TIMESTAMP_BYTES = 4

# Maximum number of tags allowed per data point.
MAX_NUM_TAGS = 8

# Number of LSBs in a qualifier reserved for flags.
FLAG_BITS = 4

# Qualifier flag bit: value is floating point (else integer).
FLAG_FLOAT = 0x8

# Mask selecting the (length-1) of a value from the qualifier flags.
LENGTH_MASK = 0x7

# All flag bits.
FLAGS_MASK = FLAG_FLOAT | LENGTH_MASK

# Max time delta (seconds) storable in a column qualifier => seconds per row.
MAX_TIMESPAN = 3600

# Width in bytes of every UID kind (metrics, tagk, tagv).
UID_WIDTH = 3

# The interpolation-free aggregator family and its underlying moment
# reductions (query-language names from later OpenTSDB; the 1.1 reference
# predates them). Canonical mapping — kernels, oracle, and the registry
# all derive from this.
NOLERP_AGGS = {"zimsum": "sum", "mimmin": "min", "mimmax": "max"}
