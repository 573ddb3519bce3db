// Trace renderer: turns starneig_jax trace JSON into matrix-activity images.
//
// Native analogue of the reference's event parser
// (misc/event_parser/parse.cpp, C++/CImg): the reference renders per-worker
// window-activity rectangles from trace.dat into images/videos.  This tool
// reads the JSON emitted by starneig_jax.tools.trace.dump_trace() and
// renders one PPM frame per time bucket showing which parts of the matrix
// each phase touched (label hashed to color, intensity by activity).
//
// Build:   g++ -O2 -o trace_render native/trace_render.cpp
// Usage:   ./trace_render trace.json out_prefix [frames=16] [size=512]
//
// The JSON schema is fixed ({"n": N, "events": [{label, begin, end,
// rect: [r, c, h, w]}...]}), so a small hand-rolled parser suffices —
// no third-party dependencies.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>
#include <algorithm>
#include <cmath>

struct Event {
    std::string label;
    double begin = 0, end = 0;
    int r = -1, c = -1, h = 0, w = 0;
    bool has_rect = false;
};

// --- minimal JSON scanning for the fixed schema ---
static void skip_ws(const std::string& s, size_t& i) {
    while (i < s.size() && isspace((unsigned char)s[i])) i++;
}

static std::string parse_string(const std::string& s, size_t& i) {
    std::string out;
    i++;  // opening quote
    while (i < s.size() && s[i] != '"') {
        if (s[i] == '\\' && i + 1 < s.size()) i++;
        out += s[i++];
    }
    i++;  // closing quote
    return out;
}

static double parse_number(const std::string& s, size_t& i) {
    size_t j = i;
    while (j < s.size() && (isdigit((unsigned char)s[j]) || s[j] == '-' ||
                            s[j] == '+' || s[j] == '.' || s[j] == 'e' ||
                            s[j] == 'E')) j++;
    double v = atof(s.substr(i, j - i).c_str());
    i = j;
    return v;
}

int main(int argc, char** argv) {
    if (argc < 3) {
        fprintf(stderr, "usage: %s trace.json out_prefix [frames] [size]\n",
                argv[0]);
        return 1;
    }
    int frames = argc > 3 ? atoi(argv[3]) : 16;
    int size = argc > 4 ? atoi(argv[4]) : 512;

    std::ifstream f(argv[1]);
    if (!f) { fprintf(stderr, "cannot open %s\n", argv[1]); return 1; }
    std::stringstream ss;
    ss << f.rdbuf();
    std::string s = ss.str();

    // matrix dimension
    long n = 0;
    size_t pos = s.find("\"n\"");
    if (pos != std::string::npos) {
        pos = s.find(':', pos) + 1;
        skip_ws(s, pos);
        if (s.compare(pos, 4, "null") != 0) n = (long)parse_number(s, pos);
    }

    std::vector<Event> events;
    size_t i = s.find("\"events\"");
    if (i == std::string::npos) { fprintf(stderr, "no events\n"); return 1; }
    i = s.find('[', i) + 1;
    while (i < s.size()) {
        skip_ws(s, i);
        if (s[i] == ']') break;
        if (s[i] == ',') { i++; continue; }
        if (s[i] != '{') { i++; continue; }
        Event ev;
        i++;  // '{'
        int depth = 1;
        while (i < s.size() && depth > 0) {
            skip_ws(s, i);
            if (s[i] == '}') { depth--; i++; break; }
            if (s[i] == ',') { i++; continue; }
            if (s[i] != '"') { i++; continue; }
            std::string key = parse_string(s, i);
            skip_ws(s, i);
            i++;  // ':'
            skip_ws(s, i);
            if (key == "label") ev.label = parse_string(s, i);
            else if (key == "begin") ev.begin = parse_number(s, i);
            else if (key == "end") ev.end = parse_number(s, i);
            else if (key == "rect") {
                if (s.compare(i, 4, "null") == 0) { i += 4; continue; }
                i++;  // '['
                double vals[4] = {0, 0, 0, 0};
                for (int k = 0; k < 4; k++) {
                    skip_ws(s, i);
                    vals[k] = parse_number(s, i);
                    skip_ws(s, i);
                    if (s[i] == ',') i++;
                }
                skip_ws(s, i);
                if (s[i] == ']') i++;
                ev.r = (int)vals[0]; ev.c = (int)vals[1];
                ev.h = (int)vals[2]; ev.w = (int)vals[3];
                ev.has_rect = true;
            } else {  // skip unknown value (string/number/null/array)
                if (s[i] == '"') parse_string(s, i);
                else if (s[i] == '[') {
                    int d = 1; i++;
                    while (i < s.size() && d) {
                        if (s[i] == '[') d++;
                        if (s[i] == ']') d--;
                        i++;
                    }
                } else { while (i < s.size() && s[i] != ',' && s[i] != '}') i++; }
            }
        }
        events.push_back(ev);
    }
    if (events.empty()) { fprintf(stderr, "no events parsed\n"); return 1; }

    double t0 = 1e300, t1 = -1e300;
    long maxdim = n > 0 ? n : 1;
    for (auto& e : events) {
        t0 = std::min(t0, e.begin);
        t1 = std::max(t1, e.end);
        if (e.has_rect) maxdim = std::max(maxdim, (long)(e.r + e.h));
        if (e.has_rect) maxdim = std::max(maxdim, (long)(e.c + e.w));
    }
    if (t1 <= t0) t1 = t0 + 1e-9;
    double scale = (double)size / (double)maxdim;

    auto hash_color = [](const std::string& lbl, unsigned char rgb[3]) {
        unsigned h = 2166136261u;
        for (char ch : lbl) h = (h ^ (unsigned char)ch) * 16777619u;
        rgb[0] = 64 + (h & 0x7F);
        rgb[1] = 64 + ((h >> 7) & 0x7F);
        rgb[2] = 64 + ((h >> 14) & 0x7F);
    };

    for (int fidx = 0; fidx < frames; fidx++) {
        double fa = t0 + (t1 - t0) * fidx / frames;
        double fb = t0 + (t1 - t0) * (fidx + 1) / frames;
        std::vector<unsigned char> img(3 * size * size, 16);
        for (auto& e : events) {
            if (e.end < fa || e.begin > fb || !e.has_rect) continue;
            unsigned char rgb[3];
            hash_color(e.label, rgb);
            int r0 = (int)(e.r * scale), c0 = (int)(e.c * scale);
            int r1 = std::min(size, (int)((e.r + e.h) * scale) + 1);
            int c1 = std::min(size, (int)((e.c + e.w) * scale) + 1);
            for (int rr = r0; rr < r1; rr++)
                for (int cc = c0; cc < c1; cc++) {
                    unsigned char* p = &img[3 * (rr * size + cc)];
                    for (int k = 0; k < 3; k++)
                        p[k] = (unsigned char)std::min(255, p[k] + rgb[k] / 4);
                }
        }
        char name[512];
        snprintf(name, sizeof name, "%s_%03d.ppm", argv[2], fidx);
        FILE* out = fopen(name, "wb");
        fprintf(out, "P6\n%d %d\n255\n", size, size);
        fwrite(img.data(), 1, img.size(), out);
        fclose(out);
    }
    printf("rendered %d frames (%zu events, n=%ld)\n", frames, events.size(),
           maxdim);
    return 0;
}
