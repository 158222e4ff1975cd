"""Command-line tools of the port (counterpart of the reference's
``tools/``): ``python -m mxnet_tpu_torch.tools.<name>`` for ``im2rec``,
``launch``, ``perfwatch`` (with its schema, ``bench_json``),
``telemetry_micro``, ``compile_micro``, ``modelwatch_micro``,
``compile_report`` and ``trace_summary``."""
