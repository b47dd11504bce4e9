"""Host-side utilities: serialization on fhe_tpu's wire format (`serial`),
the reference's cereal archives (`serial_ref`, `serial_ref_pke`),
constant-time helpers (`security`) and timing of CUDA work (`profiling`)."""
