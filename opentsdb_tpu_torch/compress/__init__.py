"""TSST4 compressed columnar blocks, the port of ``opentsdb_tpu/compress/``
(keep the scan compressed, decode only what the aggregate needs).

- codecs.py: the self-describing per-block codecs over sstable record
  bytes (numpy; a copy of the JAX package's, byte for byte);
- kernels.py: the fused decode-plus-aggregate stage, over the
  hand-written block-decode kernel (``ops/block_decode.py``);
- fused.py: the query-side block source, the coverage checks that decide
  when a range can be served straight from compressed blocks;
- devcache.py: the device cache of decoded block columns.
"""
