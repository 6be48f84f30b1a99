#!/usr/bin/env bash
# Build the native BVH tooling (analog of reference build/build-test.sh):
#  - bin/bvh_convert : offline converter CLI (reference bin/test equivalent)
#  - lib/libbvhtool.so : ctypes-callable promotion + collapse
set -euo pipefail
cd "$(dirname "$0")/../.."

mkdir -p bin lib
CXX=${CXX:-g++}
FLAGS="-std=c++20 -O3 -march=native -Wall"

$CXX $FLAGS -DBVHTOOL_MAIN raytracer/native/bvh_convert.cpp -o bin/bvh_convert
$CXX $FLAGS -shared -fPIC raytracer/native/bvh_convert.cpp \
    raytracer/native/sah_build.cpp -o lib/libbvhtool.so

echo "built bin/bvh_convert and lib/libbvhtool.so"
