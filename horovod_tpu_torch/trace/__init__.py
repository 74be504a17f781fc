"""Tracing for the port: the pure-Python span emitter (``emit.py``).

Counterpart of ``horovod_tpu/trace/``. Only the emitter is here: serve
replicas write their request spans with it. The shard merger, the
``hvd-trace`` command line and the native flight recorder come with
ROADMAP A8d; until then the reference's ``trace/merge.py`` merges the
port's shards, which share its schema.
"""
