// What the WKV-6 forward (wkv6.cu) and backward (wkv6_bwd.cu) must agree on: the
// spacing of the states that the forward's training form saves and the backward
// recomputes the old states from.  Each source is still its own library; this header
// is compiled into both, and the build's digest covers it.

#pragma once

namespace {

constexpr int CK = 16;  // tokens between the saved states: one tile of the backward

}  // namespace
