#!/bin/sh
# Build the native fast-load library next to this script.
# The Python side (dpmmsubclusters_tpu/io/npy.py) falls back to pure numpy
# when the .so is absent, so building is optional.  The library is written
# under a temporary name and renamed into place, so processes that start
# together never load a half-written file.
set -e
cd "$(dirname "$0")"
tmp="libdpmmfastload.so.tmp.$$"
trap 'rm -f "$tmp"' EXIT
g++ -O3 -march=native -fopenmp -shared -fPIC -o "$tmp" fastload.cc
mv -f "$tmp" libdpmmfastload.so
echo "built native/libdpmmfastload.so"
