# r4w-tpu container image (role of the reference Dockerfile:1-20 —
# multi-stage build to a minimal runtime with the CLI as entrypoint).
#
#   docker build -t r4w-tpu .                          # NVIDIA GPU image
#   docker build --build-arg JAX_EXTRA=cpu -t r4w-tpu:cpu .
#   docker run --rm --gpus all r4w-tpu waveform --list
#   docker run --rm -p 8080:8080 r4w-tpu explore --host 0.0.0.0
#
# The build stage has the CUDA toolkit and compiles the CUDA Viterbi
# kernel (r4w_tpu/kernels/viterbi.cu) once; the runtime stage has no
# nvcc and loads that library through R4W_CUDA_LIBRARY. Both stages
# share one Ubuntu base, so the library's glibc/libstdc++ match.

ARG CUDA_IMAGE=nvidia/cuda:12.6.3

FROM ${CUDA_IMAGE}-devel-ubuntu24.04 AS build
ARG JAX_EXTRA=cuda12
RUN apt-get update \
    && apt-get install -y --no-install-recommends python3 python3-venv \
    && rm -rf /var/lib/apt/lists/* \
    && python3 -m venv /opt/venv
ENV PATH=/opt/venv/bin:$PATH
RUN pip install --no-cache-dir \
        "jax[${JAX_EXTRA}]" numpy matplotlib pyyaml cryptography
WORKDIR /src
COPY r4w_tpu/ r4w_tpu/
COPY specs/ specs/
COPY README.md .
RUN python -m r4w_tpu.kernels.cuda /opt/r4w/lib/libr4w_cuda.so

FROM ${CUDA_IMAGE}-base-ubuntu24.04
RUN apt-get update \
    && apt-get install -y --no-install-recommends python3 \
    && rm -rf /var/lib/apt/lists/*
COPY --from=build /opt/venv /opt/venv
COPY --from=build /opt/r4w/lib /opt/r4w/lib
COPY --from=build /src/r4w_tpu /opt/r4w/r4w_tpu
COPY --from=build /src/specs /opt/r4w/specs
ENV PATH=/opt/venv/bin:$PATH \
    PYTHONPATH=/opt/r4w \
    JAX_PLATFORMS="" \
    R4W_CUDA_LIBRARY=/opt/r4w/lib/libr4w_cuda.so
WORKDIR /opt/r4w
ENTRYPOINT ["python", "-m", "r4w_tpu.cli"]
CMD ["--help"]
